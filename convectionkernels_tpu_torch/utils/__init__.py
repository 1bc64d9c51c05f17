"""Host-side helpers of the command-line encoder: image blocks, the
native blockify, texture containers and metrics."""
