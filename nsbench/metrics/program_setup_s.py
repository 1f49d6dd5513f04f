"""Seconds from the process's start to the captured loop: imports, the
CUDA context, the inputs, the engine, its settling runs and the captures;
``setup_s`` without the warm-up steps that follow, on the host's clock."""


def read(record: dict):
    return record.get("program_setup_s")
