# Build/validate flow (reference analog: C11, the SDAccel Makefile tiers —
# SURVEY.md SS2/SS4): sw_emu -> tests (CPU, Pallas interpreted),
# hw -> chip_smoke + bench on an NVIDIA GPU.

.PHONY: test oracle verify eval verify-families smoke smoke-4 bench sweep clean

oracle:            ## build the native C++ golden oracle
	python -c "from mobilenet_tpu import cpu_ref; print(cpu_ref.build(force=True))"

test: oracle       ## sw_emu tier: the pytest suite on the CPU backend
	JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'

verify:            ## per-layer golden gates (fp32 tolerance + int8 exact)
	python -m mobilenet_tpu.cli --backend cpu verify --alpha 0.25 --res 128
	python -m mobilenet_tpu.cli --backend cpu verify --alpha 0.25 --res 128 --int8

eval:              ## end-to-end top-1 agreement gate vs the golden CPU model
	python -m mobilenet_tpu.cli --backend cpu eval --alpha 0.25 --res 128 --n 16
	python -m mobilenet_tpu.cli --backend cpu eval --alpha 0.25 --res 128 --n 16 --int8

verify-families:   ## V2/V3 golden + int8-exact gates (CPU)
	python -m mobilenet_tpu.cli --backend cpu verify --model v2 --alpha 1.0 --res 96
	python -m mobilenet_tpu.cli --backend cpu verify --model v2 --alpha 1.0 --res 96 --int8
	python -m mobilenet_tpu.cli --backend cpu verify --model v3small --alpha 1.0 --res 96
	python -m mobilenet_tpu.cli --backend cpu verify --model v3small --alpha 1.0 --res 96 --int8

smoke:             ## hw tier: the end-to-end check on one NVIDIA GPU
	python chip_smoke.py

smoke-4:           ## hw tier: DP serving, channel-TP and GPipe on four GPUs
	python chip_smoke.py --cards 4

bench:             ## throughput benchmark (one JSON line, GPU only)
	python bench.py

sweep:             ## full alpha x resolution grid (GPU, slow)
	python -m mobilenet_tpu.cli --backend gpu sweep --steps 40

clean:
	rm -f mobilenet_tpu/cpu_ref/libcpuref.so mobilenet_tpu/native_io/libnativeio.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
