from igcn_cf_tpu_torch.configs.presets import (  # noqa: F401
    get_amazon_config,
    get_config,
    get_gowalla_config,
    get_yelp_config,
)
