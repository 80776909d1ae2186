"""The Karel and ViZDoom DSLs: vocabularies, parsers, interpreters,
canonical forms, samplers, and Karel's bytecode and prefix-syntax tables
(the port's copies of demo2program_tpu/dsl, numpy and the standard library
only)."""
