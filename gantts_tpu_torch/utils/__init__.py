"""Host utilities of the evaluation path."""
