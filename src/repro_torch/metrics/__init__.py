from repro_torch.metrics.timeseries import MetricsStore, Rollup, TimeSeries

__all__ = ["MetricsStore", "Rollup", "TimeSeries"]
