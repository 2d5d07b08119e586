"""The geometric mean of every answered query's latency in the window:
the form of TPC-H's Power@Size (clause 5.4.1), which weighs each query
alike, short or long."""
import math


def read(w):
    lat = w.latencies_ms
    if not lat:
        return None
    return math.exp(sum(math.log(x) for x in lat) / len(lat))
