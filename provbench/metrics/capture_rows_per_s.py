"""Input rows of the pipelines captured in the window over its length."""


def read(rec):
    if "captures" not in rec or not rec.get("window_s"):
        return None
    return rec["captures"] * rec["input_rows"] / rec["window_s"]
