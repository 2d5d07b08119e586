"""The stream's throughput: queries answered over the window's seconds
(first send to last result)."""


def read(w):
    return len(w.latencies_ms) / w.window_s if w.window_s > 0 else None
