"""setup_s: start of the process to the start of the window (host clock):
imports, the card's context, the build on a first run, the CRS, the tracker
set and the proof chain the mix needs, and the warm-up requests."""


def read(data):
    return data.setup_s
