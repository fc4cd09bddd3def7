"""Published architecture configs used by the port."""
