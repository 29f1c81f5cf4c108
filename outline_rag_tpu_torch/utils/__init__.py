"""Shared pure utilities: chunking, hashing/signatures, logging, ids."""
