"""Command-line apps of the port: `image_io` (one stereo pair, every
stage dumped to files) and `video_io` (a stream of SBS frames)."""
