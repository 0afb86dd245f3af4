"""The 95th percentile of the traced requests' latencies (from due time)
in a cell offered more than the system sustains: the backlog grows all
through the window, so it swings with the smallest change and is
recorded, not judged."""

from benchmark.window import percentile


def read(r):
    lat = r.work.get("request_latency_s")
    return 1e3 * percentile(lat, 95) if lat else None
