"""Test-support machinery that ships with the package.  Port of
``repro/testing``.

:mod:`repro_torch.testing.faults` is the chaos/fault-injection harness — it
lives under ``src`` (not ``tests/``) because the serving layer's fault
taxonomy is a *contract*: operators reproduce a production quarantine
record by corrupting a blob the exact same deterministic way the test
suite does.
"""
