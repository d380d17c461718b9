"""Generation pipeline."""
