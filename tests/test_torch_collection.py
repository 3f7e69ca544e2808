"""Collection stays cheap: importing the port's test modules compiles nothing.

Under `pytest -n N --dist loadfile` every worker imports every test module to
collect it, so a reference value computed at import is paid by all workers
before any test runs.  Reference values are built by the tests that ask for
them (module fixtures and cached accessors).  This test imports `conftest` and
then every `tests/test_torch_*.py` module in a fresh interpreter and counts
the XLA compiles that the imports trigger: there must be none.
"""

import json
import pathlib
import subprocess
import sys

TESTS = pathlib.Path(__file__).resolve().parent

CHILD = r"""
import importlib, json, pathlib, sys

tests = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(tests.parent), str(tests)]
import jax.monitoring

count = [0]


def listener(event, duration, **kwargs):
    if event == "/jax/core/compile/backend_compile_duration":
        count[0] += 1


jax.monitoring.register_event_duration_secs_listener(listener)
compiles = {}
for name in ["conftest"] + sorted(p.stem for p in tests.glob("test_torch_*.py")):
    before = count[0]
    importlib.import_module(name)
    compiles[name] = count[0] - before
print(json.dumps(compiles))
"""


def test_importing_port_test_modules_compiles_nothing():
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(TESTS)], cwd=TESTS.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    compiles = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(compiles) > 40, sorted(compiles)
    assert "test_torch_backend" in compiles
    assert {k: v for k, v in compiles.items() if v} == {}
