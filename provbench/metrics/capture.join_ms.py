"""Mean host time of the tracked join up to a synchronise, ms."""
import statistics


def read(rec):
    spans = rec.get("spans", {}).get("capture.join")
    return statistics.fmean(spans) * 1e3 if spans else None
