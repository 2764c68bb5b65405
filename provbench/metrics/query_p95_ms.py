"""95th percentile of every query latency in the window (ms): closed loop
from the start of building the plan to the synchronised answer, open loop
from when the query was due; a refused or failed query counts with the
time until the benchmark gave up on it."""
import statistics


def read(rec):
    lat = rec.get("latencies_ms")
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
