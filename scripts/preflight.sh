#!/bin/bash
# Pre-commit preflight: refuse to commit red. Run from anywhere:
#   bash scripts/preflight.sh
set -e
cd "$(dirname "$0")/.."
echo "== full suite (CPU, 8-device virtual mesh) =="
python -m pytest tests/ -x -q -n 4
echo "== multi-chip dryrun =="
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
  timeout 600 python -c "import __graft_entry__ as e; e.dryrun_multichip(8); print('dryrun ok')"
echo "== chip_smoke.py rehearsal (tiny sizes, CPU; never prints the ok line) =="
JAX_PLATFORMS=cpu timeout 600 python chip_smoke.py --tiny
XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
  timeout 600 python chip_smoke.py --tiny --multi
echo "== entry compile check =="
JAX_PLATFORMS=cpu timeout 300 python - << 'PY'
import jax; jax.config.update("jax_platforms", "cpu")
import __graft_entry__ as e
fn, args = e.entry()
jax.jit(fn).lower(*args).compile()
print("entry ok")
PY
echo "PREFLIGHT GREEN"
