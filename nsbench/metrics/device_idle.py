"""1 - busy / window over the traced stretch, in %: the union of device
operations' intervals against the time from the first one's start to the
last one's end."""


def read(record: dict):
    if record["window_ms"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_ms"] / record["window_ms"])
