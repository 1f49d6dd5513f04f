"""Steps of the traced stretch whose ``solution["rebuilt"]`` is 1, in %,
summed on the device by the tally graph; nothing to read for a step that
carries nothing."""


def read(record: dict):
    rebuilt = record["counters"].get("rebuilt")
    if rebuilt is None:
        return None
    return 100.0 * rebuilt / record["steps"]
