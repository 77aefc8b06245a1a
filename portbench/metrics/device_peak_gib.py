"""Peak device memory allocated in the window
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`)."""


def read(record):
    peak = record["memory"].get("window_peak_bytes")
    return peak / 2**30 if peak else None
