"""Device idle share over the remap cell's traced window."""

from perfbench.metrics._device import idle_share


def read(run):
    return idle_share(run)
