"""The world's build in the set-up: W1's slabs, the slot assignment and,
where the world has one, the line table with its brick lines, on the host
clock with the card synchronised before and after."""

LAYER = "world build"
UNIT = "s"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(run):
    return run.world_build_s or None
