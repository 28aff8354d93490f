"""The 90th percentile (nearest rank) of the serving window's request
latencies, from when each request was due to when ``generate()``
returned, a failed one infinite. Above the knee the queue grows all
through the window, so this tail swings with the smallest change: it is
recorded here and not judged."""
from bench_h100.harness import nearest_rank


def read(ctx):
    lat = ctx.get('latencies')
    return nearest_rank(lat, 0.9) if lat else None
