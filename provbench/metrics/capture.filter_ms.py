"""Mean host time of the tracked filter up to a synchronise, ms."""
import statistics


def read(rec):
    spans = rec.get("spans", {}).get("capture.filter")
    return statistics.fmean(spans) * 1e3 if spans else None
