"""Text tokenizers for the serving path."""
