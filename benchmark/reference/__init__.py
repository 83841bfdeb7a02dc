"""The plain reference renderer and the benchmark's own BVH, imported by nothing of the program."""
