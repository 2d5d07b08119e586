"""Set-up: tables made on the device, loaded as DeviceBatches, each
query warmed with each of its substitution sets (and, in a checkout's
first run, the port's CUDA libraries built)."""


def read(w):
    return w.setup_s
