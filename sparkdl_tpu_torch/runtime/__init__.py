"""Process-level plumbing: env knobs, device selection, kernel builds."""
