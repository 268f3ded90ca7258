"""The set-up's build or load of the hand-written kernels, in seconds:
the program's last kept ``diffco.native.build`` span that ended before
the first traced request (none where the set-up launches no
hand-written kernel). Host clock."""
from portbench.metrics import _spans


def read(ctx):
    builds = _spans.in_setup(ctx, 'diffco.native.build')
    return ((builds[-1].end_ns - builds[-1].start_ns) * 1e-9 if builds
            else None)
