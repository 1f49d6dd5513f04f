"""Device ms per ``zsort`` span: one replay of the z-sort graph."""


def read(record: dict):
    ms = record["span_ms"].get("zsort")
    if not ms or not record["zsorts"]:
        return None
    return ms / record["zsorts"]
