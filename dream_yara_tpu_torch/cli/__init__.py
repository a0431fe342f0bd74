"""Command-line tools of the port: `dream-yara-tpu-torch-indexer`,
`-build-filter`, `-update-filter` (host-only copies of the reference's) and
`-mapper` (maps on the device DY_PLATFORM names)."""
