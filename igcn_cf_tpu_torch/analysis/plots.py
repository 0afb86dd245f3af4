"""Paper-figure reproduction (port of ``igcn_cf_tpu/analysis/plots.py``;
reference run/plot.py).

The reference's active figure plots the template-ratio sweep from hard-coded
experiment results (reference run/plot.py:101-133). Here the same figure
can be produced either from those published reference numbers (kept
verbatim for comparison) or from fresh sweep results produced by
``template_ratio_sweep``, which trains on ``device`` (the card unless the
caller asks for the CPU). Plotting needs matplotlib, imported only inside
the plotting function; the data-producing functions work without it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# published reference results (reference run/plot.py:101-108), NDCG@20 in %
REFERENCE_TEMPLATE_SWEEP = {
    "ratio": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0],
    "MF": [11.934] * 10,
    "INMO-MF-degree": [8.925, 10.876, 12.014, 12.762, 13.251, 13.648, 13.775,
                       13.926, 14.096, 14.095],
    "INMO-MF-error_sort": [9.289, 11.197, 12.335, 13.0, 13.512, 13.795,
                           13.888, 13.964, 14.164, 14.095],
    "INMO-MF-page_rank": [9.344, 11.141, 12.289, 12.975, 13.336, 13.786,
                          13.879, 14.022, 14.101, 14.095],
    "LightGCN": [14.037] * 10,
    "INMO-LGCN-degree": [13.162, 14.231, 14.671, 14.963, 15.109, 15.253,
                         15.19, 15.344, 15.329, 15.341],
    "INMO-LGCN-error_sort": [13.416, 14.468, 15.008, 15.137, 15.241, 15.323,
                             15.329, 15.367, 15.406, 15.341],
    "INMO-LGCN-page_rank": [13.376, 14.37, 14.873, 15.09, 15.191, 15.321,
                            15.337, 15.38, 15.413, 15.341],
}


def template_ratio_sweep(
    dataset_config: dict,
    model_config: dict,
    trainer_config: dict,
    ratios: Sequence[float] = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
    ranking_metrics: Sequence[str] = ("degree", "sort", "page_rank"),
    seed: int = 2021,
    device="cuda",
) -> Dict[str, List[float]]:
    """Re-run the template-ratio experiment that produced reference figure 2
    (reference run/plot.py:101-133): train INMO at each feature_ratio x
    ranking metric, record test NDCG@topks[0] in %."""
    from igcn_cf_tpu_torch.core.prng import set_seed
    from igcn_cf_tpu_torch.data.dataset import get_dataset
    from igcn_cf_tpu_torch.models.base import get_model
    from igcn_cf_tpu_torch.train.trainer import get_trainer

    out: Dict[str, List[float]] = {"ratio": list(ratios)}
    for metric in ranking_metrics:
        ndcgs = []
        for ratio in ratios:
            set_seed(seed)
            ds = get_dataset(dataset_config)
            mc = dict(model_config, feature_ratio=ratio, ranking_metric=metric)
            model = get_model(mc, ds, device)
            trainer = get_trainer(dict(trainer_config), ds, model)
            trainer.train(verbose=False)
            _, metrics = trainer.eval("test")
            ndcgs.append(metrics["NDCG"][trainer.topks[0]] * 100.0)
            del trainer, model  # this point's buffers (P) before the next's
        out[metric] = ndcgs
    return out


def plot_template_ratio(sweep: Dict[str, List[float]], out_path: str) -> None:
    """Figure 2 as a PNG at ``out_path``; needs matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4), constrained_layout=True)
    ratio = sweep["ratio"]
    for label, series in sweep.items():
        if label == "ratio":
            continue
        ax.plot(ratio, np.asarray(series) / 100.0, marker="o", label=label)
    ax.set_xticks(ratio)
    ax.set_xlabel("Percentage of template users/items")
    ax.set_ylabel("NDCG@20")
    ax.legend()
    fig.savefig(out_path)
    plt.close(fig)
