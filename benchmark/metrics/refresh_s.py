"""Wall seconds of the set-up's ``Recommender.refresh`` onto the grown
catalog (graph rebuild, representations, exclusion words), which ends in a
synchronize."""


def read(r):
    return r.e2e.get("refresh_s")
