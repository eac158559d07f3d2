"""Speaker banks and per-stream conditioning."""
