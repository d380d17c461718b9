"""Parameter converters."""
