"""Core datapath, BVH, traversal and session layers of the port."""
