"""Data parallelism of the port: the process group (`dist`) and the
sharded roll of a width-sharded map (`spatial`)."""
