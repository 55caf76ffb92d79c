"""launches_per_request: CUDA kernel launches in the profiled requests, as
torch.profiler sees them on the card (copies and fills left out), over the
requests profiled."""


def read(data):
    p = data.profile
    if not p or not p["launches"]:
        return None
    return p["launches"] / p["requests"]
