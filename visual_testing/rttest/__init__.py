"""rttest: snapshot + performance regression harness for the renderer.

Capability parity with the reference harness (visual-testing/src/rttest/):
renders every scene in tests/tests.toml through the real CLI, compares EXR
outputs against locally-blessed references (default tolerance 0.0 =
bit-exact, valid because renders are deterministic), and tracks wall-clock
per scene in an append-only jsonl with blessed baselines.
"""
