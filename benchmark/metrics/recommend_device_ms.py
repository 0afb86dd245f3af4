"""Mean device milliseconds per request launched inside ``recommend``: the
ids' copy in, the gather of the users' rows, K5 and the ids' copy out."""


def read(r):
    if r.trace is None or not r.work.get("request_users"):
        return None
    return 1e3 * r.trace.by_range.get("recommend", 0.0) \
        / len(r.work["request_users"])
