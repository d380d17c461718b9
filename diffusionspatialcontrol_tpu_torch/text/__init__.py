"""Text front end: tokenizer and prompt encoder."""
