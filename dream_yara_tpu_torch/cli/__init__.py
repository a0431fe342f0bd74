"""Command-line tools of the port: the mapper (`dream-yara-tpu-torch-mapper`).
The indexer and the filter tools are host-only and shared with the
reference (`dream-yara-tpu-indexer`, `-build-filter`, `-update-filter`)."""
