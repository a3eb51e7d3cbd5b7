.PHONY: lint test test-gpu smoke bench

lint:
	python -m flake8 rankfm_tpu/ --max-line-length=120 || true

test:
	python -m pytest tests/ -x -q

# gpu-marked tests (scaled oracle-parity gates) on the local GPU
test-gpu:
	RANKFM_TEST_GPU=1 python -m pytest tests/ -m gpu -q

# the main path on one GPU, checked against its references
smoke:
	python chip_smoke.py

bench:
	python bench.py
