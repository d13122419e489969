"""The general generators of the traffic mixes: a mix's file names its
generator, `generators/<generator>.py`, whose `measure` runs one cell."""
