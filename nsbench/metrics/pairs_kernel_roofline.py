"""Share of its least time that the pairs kernel reaches, in %: the least
time of one step (``roofline.least_time``, from the benchmark's inputs)
over the device ms per step of the pairs kernels (K2a, K2b, K3, K4, K5 by
name) in the ``step`` spans of the traced stretch."""


def read(record: dict):
    ms = sum(v for name, v in record["kernel_ms"].get("step", {}).items()
             if any(k in name for k in record["pairs_kernels"]))
    if ms <= 0 or not record.get("least"):
        return None
    return 100.0 * record["least"]["least_ms"] / (ms / record["steps"])
