"""Mean host time of ``QuerySession.run`` up to a synchronise, ms."""
import statistics


def read(rec):
    spans = rec.get("spans", {}).get("run")
    return statistics.fmean(spans) * 1e3 if spans else None
