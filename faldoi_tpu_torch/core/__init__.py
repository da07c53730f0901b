"""Core algorithm: preprocessing, patch and global solvers, pruning,
the local growing and the iterated match growing."""
