"""The Karel DSL: vocabulary, parser, interpreter, canonical forms, bytecode,
sampler and the prefix-syntax tables (the port's copies of
demo2program_tpu/dsl, numpy and the standard library only)."""
