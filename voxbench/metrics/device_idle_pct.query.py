"""The share of the traced window in which no operation ran on the card
(``torch.profiler``), in the query cell."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "query_mrays_per_s"


def read(run):
    return run.idle_pct("raytrace")
