"""Share of the traced window in which nothing ran on the device, %."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr["device_ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
