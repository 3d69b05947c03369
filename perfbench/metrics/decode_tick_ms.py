"""The engine's mean decode tick over the window: its own host-clock tick
time (each tick ends in its one device-to-host read) over its ticks."""

LAYER = "engine (runtime/serving.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "itl_mean_ms"


def read(rec):
    n = rec.delta("serving.decode_steps")
    return 1e3 * rec.delta("time.tick_seconds") / n if n else None
