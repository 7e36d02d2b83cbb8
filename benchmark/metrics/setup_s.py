"""From the start of the benchmark's process to the window's start: the
table drawn and built, loaded, registered and every template warmed."""


def read(run):
    return run.setup_s
