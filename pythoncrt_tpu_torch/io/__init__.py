"""Host media I/O of the port (video.py)."""
