cd build/checkout
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
(time python3 chip_smoke.py) > ../../chiprun_out/smoke_rev2.log 2>&1
echo smoke_rc=$?
grep -a "^\[dp-\|^\[pipeline\]\|^\[augment\]\|^\[launches\] data" ../../chiprun_out/smoke_rev2.log | cut -c1-2500
tail -c 1500 ../../chiprun_out/smoke_rev2.log
(time python -m pytest --noconftest -p no:cacheprovider -q -m gpu tests/test_torch_nnue_kernels_gpu.py tests/test_torch_input_pipeline_gpu.py tests/test_torch_augment_gpu.py tests/test_torch_etiny_gpu.py tests/test_torch_probes_gpu.py tests/test_torch_engine_gpu.py tests/test_torch_parallel_gpu.py) > ../../chiprun_out/gpu_rev2.log 2>&1
echo gpu_rc=$?
tail -15 ../../chiprun_out/gpu_rev2.log
