"""Seconds from the start of the run to the start of the measured window:
torch and the CUDA context, the stream made from the seed, the port's
builds (first run in a checkout), the backend and its warm passes."""


def read(run):
    return run.setup_s
