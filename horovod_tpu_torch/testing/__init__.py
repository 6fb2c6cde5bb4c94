"""Test harness pieces shipped with the port: deterministic fault
injection (`testing.faults`)."""
