import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Tests run on the single real CPU device.  Multi-device tests spawn
# subprocesses with XLA_FLAGS (see tests/util.py) so the main process never
# locks a fake device count.


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: spawns subprocesses with fake XLA devices (slow, "
        "needs spare cores); deselect on constrained runners with "
        '-m "not multidevice"')
    config.addinivalue_line(
        "markers",
        "fault: fault-injection matrix (repro.core.faults) — exercises "
        "the health-guard ladder, the quantization journal, and torn "
        'checkpoints; deselect with -m "not fault"')
    config.addinivalue_line(
        "markers",
        "serving: multi-tenant serving engine (repro.serve) — parity "
        "oracle + scheduler property tests; runs on CPU in the default "
        "suite (interpret-mode kernels, no backend gates)")
    config.addinivalue_line(
        "markers",
        "cuda: runs a hand-written CUDA kernel of repro_torch on an NVIDIA "
        "GPU; skipped (inside the test) on hosts without CUDA")
