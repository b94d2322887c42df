# Common targets. chip-smoke and bench need an NVIDIA card; everything
# else runs on CPU (the conftest pins the platform and enables x64).

.PHONY: test golden chip-smoke bench dryrun

test:
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'

golden:
	python scripts/golden_check.py

chip-smoke:
	python chip_smoke.py

bench:
	python bench.py

dryrun:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c \
	  "import jax; jax.config.update('jax_platforms', 'cpu'); \
	   import __graft_entry__ as e; e.dryrun_multichip(8)"
