"""The port stands alone: it imports neither jax nor the JAX package, and
its entry point runs on cuda unless the caller asks for the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["rav1e_tpu"] = None    # so does any import of the JAX package
import numpy as np
import rav1e_tpu_torch
import chip_smoke
from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
from rav1e_tpu_torch.pipeline.tpu_inter import encode_gop_tpu
planes = chip_smoke.synth(64, 64)[0]
pkt, rec = encode_keyframe_tpu(planes, 100, speed=7, cdef=(0, 0, 0, 0, 3),
                               device="cpu")
assert len(pkt) > 100 and [r.shape for r in rec] == [(64, 64), (32, 32),
                                                      (32, 32)]
pkts, recs = encode_gop_tpu(chip_smoke.synth(64, 64, n=2), 100, speed=7,
                            cdef=(0, 0, 0, 0, 3), device="cpu")
assert pkts[0] == pkt and len(pkts) == 2
assert [tuple(r.shape) for r in recs[1]] == [(64, 64), (32, 32), (32, 32)]
pkt6, _ = encode_keyframe_tpu(planes, device="cpu")     # speed 6
assert len(pkt6) > 100
pkts6, _ = encode_gop_tpu(chip_smoke.synth(64, 64, n=2), 100, speed=6,
                          cdef=(0, 0, 0, 0, 3), device="cpu")
assert len(pkts6) == 2 and len(pkts6[1]) > 0
import rav1e_tpu_torch.cli.main
import rav1e_tpu_torch.conform.aom
import rav1e_tpu_torch.conform.dav1d
import rav1e_tpu_torch.pipeline.inter
import rav1e_tpu_torch.analysis.quality
import rav1e_tpu_torch.capi.bridge
import rav1e_tpu_torch.conform.parse
import rav1e_tpu_torch.conform.rav1e_ref
from rav1e_tpu_torch.parallel.dryrun import dryrun_multichip
assert dryrun_multichip(2, ["cpu", "cpu"])["gop_packets"] == 6
from rav1e_tpu_torch.api import Config
ctx = Config(width=64, height=64).new_context(device="cpu")   # speed 6
assert ctx._la_depth == 8 and ctx._bgroup == 4
for f in chip_smoke.synth(64, 64, n=5):
    ctx.send_frame(f)
ctx.flush()
got = []
while True:
    _, p = ctx.receive_packet()
    if p is None:
        break
    got.append((p.frame_type, p.input_frameno))
assert got == [("KEY", 0), ("INTER", 4), ("INTER", 2), ("INTER", 1),
               ("SHOW_EXISTING", 2), ("INTER", 3), ("SHOW_EXISTING", 4)], got
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "rav1e_tpu"))]
assert not bad, bad
# the C++ packer the port loaded is its own, not the JAX package's
with open("/proc/self/maps") as f:
    maps = f.read()
assert "rav1e_tpu/native/" not in maps
assert "rav1e_tpu_torch/build/libpacker_" in maps
print("ok", len(pkt))
"""


def test_port_runs_with_jax_and_reference_blocked():
    """In a subprocess where importing jax or rav1e_tpu fails, the port
    (and chip_smoke.py) imports and encodes a 64x64 keyframe and a
    KEY + P GOP on the CPU, at speed 7 with CDEF, the default (speed-6)
    keyframe and a speed-6 KEY + P GOP with CDEF; the session API, the
    CLI, the numpy inter pipeline, the dav1d and libaom shims, the host
    modules and the C API's bridge import, dryrun_multichip runs over two
    CPU devices, and a default Context (speed 6, reordered, lookahead 8)
    codes 5 frames."""
    res = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_source_scan_no_jax_no_reference_imports():
    """No `import jax` / `from jax` and no module name rav1e_tpu (one not
    followed by `_torch`) in the port or chip_smoke.py. A repository
    path (`rav1e_tpu/...`) names the reference's files in docs and in
    the kernels line; it is not a module. Neither they nor the port's
    C++/CUDA sources name the JAX package's packer library
    (`rav1e_tpu/native`, `libpacker`): the port builds its own. The C
    API shim (capi/capi.c), which embeds CPython, imports no module of
    rav1e_tpu either: its only module is rav1e_tpu_torch's bridge."""
    files = sorted((ROOT / "rav1e_tpu_torch").rglob("*.py"))
    for copied in ("pipeline/inter.py", "pipeline/intra.py",
                   "conform/aom.py", "conform/dav1d.py"):
        assert ROOT / "rav1e_tpu_torch" / copied in files, copied
    files.append(ROOT / "chip_smoke.py")
    jax_imp = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
    ref_mod = re.compile(r"\brav1e_tpu(?!_torch|/)\b")
    ref_lib = re.compile(r"rav1e_tpu/native|libpacker")
    for f in files:
        src = f.read_text()
        assert not jax_imp.search(src), f
        m = ref_mod.search(src)
        assert m is None, (f, src[max(0, m.start() - 40): m.end() + 40])
    shim = (ROOT / "rav1e_tpu_torch" / "capi" / "capi.c").read_text()
    assert re.findall(r'PyImport_ImportModule\("([\w.]+)"\)', shim) == \
        ["rav1e_tpu_torch.capi.bridge"]
    m = re.search(r"\brav1e_tpu\.", shim)
    assert m is None, shim[max(0, m.start() - 40): m.end() + 40]
    srcs = sorted((ROOT / "rav1e_tpu_torch" / "csrc").iterdir())
    assert any(f.suffix == ".cpp" for f in srcs)
    for f in files + srcs:
        m = ref_lib.search(f.read_text())
        assert m is None, (f, m.group(0))


def test_entry_point_without_device_and_without_cuda_raises():
    """No device argument means cuda; with no CUDA that raises and
    names the way out, rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    planes = [np.zeros((64, 64), np.uint8), np.zeros((32, 32), np.uint8),
              np.zeros((32, 32), np.uint8)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encode_keyframe_tpu(planes, 100, speed=8)


def test_context_without_device_and_without_cuda_raises():
    """Config().new_context() means cuda, as the CLI's default does; with
    no CUDA it raises before any frame, naming the way out."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is available")
    from rav1e_tpu_torch.api import Config
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Config().new_context()


def test_options_beyond_the_slice_raise():
    """A device keyframe asked for a bit depth above 8 raises
    NotImplementedError naming its ROADMAP item even where the planes'
    values fit in 8 bits (seq_extra's bit_depth; planes above 255 raise
    in test_high_bit_depth_raises), rather than coding a stream whose
    header says 10 bits from the 8-bit path."""
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    planes = [np.full((64, 64), 200, np.uint16),
              np.full((32, 32), 200, np.uint16),
              np.full((32, 32), 200, np.uint16)]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        encode_keyframe_tpu(planes, 100, speed=7, device="cpu",
                            seq_extra={"bit_depth": 10})


def test_deferred_keyframe_finish_equals_the_direct_call():
    """deferred=True on the CPU returns (finish, rec_dev): finish() gives
    the direct call's packet and recon, rec_dev that recon's planes."""
    import chip_smoke
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    planes = chip_smoke.synth(64, 64)[0]
    pkt, rec = encode_keyframe_tpu(planes, 100, speed=7, device="cpu")
    finish, rec_dev = encode_keyframe_tpu(planes, 100, speed=7,
                                          device="cpu", deferred=True)
    pkt_d, rec_d = finish()
    assert pkt_d == pkt
    for a, b, c in zip(rec, rec_d, rec_dev):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c.numpy())


@pytest.fixture(scope="module")
def speed6_keyframe():
    import chip_smoke
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    planes = chip_smoke.synth(64, 64)[0]
    return planes, encode_keyframe_tpu(planes, 100, cdef=(0, 0, 0, 0, 3),
                                       device="cpu")[0]


@pytest.mark.parametrize("speed", [5, 0])
def test_speeds_below_6_are_the_speed_6_keyframe(speed, speed6_keyframe):
    """The keyframe reads the same toolset at speeds 0-6 (api/speed.py),
    so speeds 5 and 0 give the default (speed 6) packet byte for byte;
    none raises."""
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    planes, pkt6 = speed6_keyframe
    pkt, _ = encode_keyframe_tpu(planes, 100, speed=speed,
                                 cdef=(0, 0, 0, 0, 3), device="cpu")
    assert pkt == pkt6


def test_high_bit_depth_raises():
    from rav1e_tpu_torch.pipeline.tpu_intra import encode_keyframe_tpu
    planes = [np.full((64, 64), 300, np.uint16),
              np.full((32, 32), 300, np.uint16),
              np.full((32, 32), 300, np.uint16)]
    with pytest.raises(NotImplementedError, match="bit depth.*ROADMAP"):
        encode_keyframe_tpu(planes, 100, speed=8, device="cpu")
