"""The port's dry run of the tile-sharded pass B on an 8-slot CPU mesh,
(2, 4): dryrun_multichip(8) (parallel/dryrun.py), some 70 s on the CPU
(the plain replay of the 2048x256 frame's four stripes), beside the
other slot counts of tests/test_torch_dryrun.py."""
from test_torch_dryrun import check_multichip
from test_torch_threads import one_torch_thread  # noqa: F401


def test_dryrun_multichip_cpu_8_slots(capsys):
    check_multichip(8, capsys)
