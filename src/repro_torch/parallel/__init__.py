"""Distribution layer of the torch port: logical sharding on DTensor,
compressed collectives and the GPipe pipeline."""
