"""Mean host time of building a plan (``.plan()``), ms."""
import statistics


def read(rec):
    spans = rec.get("spans", {}).get("plan")
    return statistics.fmean(spans) * 1e3 if spans else None
