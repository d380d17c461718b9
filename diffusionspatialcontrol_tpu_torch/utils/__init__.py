"""Phase timing, the watchdog and region-map helpers."""
