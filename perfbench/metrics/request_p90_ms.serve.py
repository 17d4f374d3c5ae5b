"""The window's 90th percentile of request latency (ms), timed as
``request_p50_ms`` is: from when a request was due to the last byte of its
PNG, a failed one counting as infinitely late."""


def read(record):
    return record.counters.get('request_p90_ms')
