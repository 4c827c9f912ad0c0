"""The 95th percentile of every request's latency in the window, call to
numpy result, in ms."""
import statistics


def read(run):
    lat = run.window.latencies
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[94]
