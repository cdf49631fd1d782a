"""The benchmark of ffmpeg_hybrid_tpu_torch, the PyTorch and CUDA VP9
decoder: VP9 streams decoded on one card by sessions that each own a
decoder, judged on frames per second and frame latency.

`python vp9bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json and prints one JSON line.
Configurations, traffic mixes and per-layer metric readers are files
found by name: configs/<config>.json, traffic/<mix>.json and
metrics/<metric>.py.
"""
