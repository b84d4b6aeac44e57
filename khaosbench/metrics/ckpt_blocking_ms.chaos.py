"""Mean ``SaveReport.blocking_s`` of the window's triggers (the job's own
span around its synchronous save), in ms, under failures."""
from khaosbench.metrics._blocking import mean_blocking_ms as read  # noqa: F401
