"""Share of the profiled sample's wall in which no kernel, copy or set ran
on the card, in percent (1 - busy_s / window_s). Moves reads_per_s."""

def read(run: dict) -> float | None:
    dev = run.get("device")
    if not dev or dev["window_s"] <= 0 or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
