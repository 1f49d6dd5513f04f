"""Device ms per ``step`` span in every kernel, copy and memset that is
not one of the port's own CUDA kernels: the prep, sort, grid, records and
epilogue, written in PyTorch."""


def read(record: dict):
    ops = record["kernel_ms"].get("step", {})
    if not ops:
        return None
    return sum(v for name, v in ops.items()
               if not any(k in name for k in record["port_kernels"])) \
        / record["steps"]
