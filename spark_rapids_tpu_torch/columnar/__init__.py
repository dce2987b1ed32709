"""Device columnar batches, dictionary encoding and the Arrow bridge."""
