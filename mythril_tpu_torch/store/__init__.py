"""The verdict store's pieces the port needs so far: the selector mask
feed of the JAX package's store/diff.py."""
