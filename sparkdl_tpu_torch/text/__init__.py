"""Text-path engine pieces (sequence-length bucketing)."""
