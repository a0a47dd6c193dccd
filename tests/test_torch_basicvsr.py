"""BasicVSR (``models/basicvsr.py``) and K4's plain version on the CPU,
against a transcription of BasicSR's modules (``tests/basicvsr_reference.py``)
and the benchmark's plain float32 reference (``perfbench/reference/
basicvsr.py``), at a small size (width 16, 2 blocks a branch, 5 frames of
40 x 72) on seeded weights: the flow warp in both padding modes and on
channel windows of a wider tensor, both branches' trunks stepped as one
(grouped convs over their stacked states), the parameter count at
published widths, the import of BasicSR's state-dict
layout and its refusals, an ``.isr`` round trip, a 37-frame clip through
``rs`` in segments of 15, 15 and 7, and the paths that refuse a sequence
model."""

import math

import cv2
import numpy as np
import pytest
import torch

import basicvsr_reference as ref
import torch_threads  # noqa: F401  (shares the CPU cores among the test workers)
from image_super_resolution_tpu_torch.cli import rs
from image_super_resolution_tpu_torch.infer.engine import TiledUpscaler
from image_super_resolution_tpu_torch.interop.from_jax import params_to_jax
from image_super_resolution_tpu_torch.interop.torch_import import import_basicvsr_state
from image_super_resolution_tpu_torch.models.basicvsr import BASICVSR_MEAN, BASICVSR_STD
from image_super_resolution_tpu_torch.models.deploy import (
    DeployedModel,
    DeploySpec,
    family_defaults,
    infer_family_dims,
    load_artifact,
    read_artifact,
    save_artifact,
)
from image_super_resolution_tpu_torch.ops.kernels import flow_warp as k4
from image_super_resolution_tpu_torch.utils.serialization import map_tree, to_fp16, to_fp32
from image_super_resolution_tpu_torch.video import recorder
from perfbench.harness.weights import make_weights
from perfbench.reference import basicvsr as plain

WIDTH, BLOCKS = 16, 2
SMALL = DeploySpec(family="basicvsr", width=WIDTH, blocks=BLOCKS, scale=4, mean=BASICVSR_MEAN,
                   std=BASICVSR_STD)
CFG = {"width": WIDTH, "blocks": BLOCKS, "segment": 15, "frame_size": [270, 480],
       "precision": "bfloat16"}


def frames(seed: int, t: int = 5, h: int = 40, w: int = 72) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (t, h, w, 3), dtype=np.uint8)


def source_model(seed: int) -> ref.BasicVSR:
    """BasicSR's module with torch's default Conv2d init from ``seed``:
    U(+-1/sqrt(fan_in)) for every kernel and bias."""
    torch.manual_seed(seed)
    return ref.BasicVSR(num_feat=WIDTH, num_block=BLOCKS).eval()


def source_state(model: ref.BasicVSR) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def lsb(got: np.ndarray, want: np.ndarray) -> tuple:
    """(largest per-frame RMS, largest difference) in 8-bit steps."""
    d = got.astype(np.float64) - want.astype(np.float64)
    return max(float(np.sqrt(np.mean(f * f))) for f in d), float(np.abs(d).max())


# ---------------------------------------------------------------- K4 -------

def kernel_arithmetic(x, flow, padding):
    """K4's own arithmetic in float64 (``csrc/flow_warp.cu``): the point
    ``(j + fx, i + fy)`` (coordinate 0 on a side of length 1), clipped for
    ``border``, and the grid sampler's four corner weights."""
    n, h, w, c = x.shape
    xd, fd = x.double(), flow.double()
    jj = torch.arange(w, dtype=torch.float64).view(1, 1, w)
    ii = torch.arange(h, dtype=torch.float64).view(1, h, 1)
    ix = jj + fd[..., 0] if w > 1 else torch.zeros_like(fd[..., 0])
    iy = ii + fd[..., 1] if h > 1 else torch.zeros_like(fd[..., 1])
    if padding == "border":
        ix, iy = ix.clamp(0, w - 1), iy.clamp(0, h - 1)
    x0, y0 = ix.floor(), iy.floor()
    out = torch.zeros(n, h, w, c, dtype=torch.float64)
    b = torch.arange(n).view(n, 1, 1).expand(n, h, w)
    for cx, cy, wt in ((x0, y0, (x0 + 1 - ix) * (y0 + 1 - iy)), (x0 + 1, y0, (ix - x0) * (y0 + 1 - iy)),
                       (x0, y0 + 1, (x0 + 1 - ix) * (iy - y0)), (x0 + 1, y0 + 1, (ix - x0) * (iy - y0))):
        inside = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        v = xd[b, cy.clamp(0, h - 1).long(), cx.clamp(0, w - 1).long()]
        out += torch.where(inside[..., None], v * wt[..., None], torch.zeros(()))
    return out


@pytest.mark.parametrize("padding", k4.PADDING)
@pytest.mark.parametrize("n,h,w,c", [(2, 9, 15, 3), (1, 40, 72, 16), (3, 1, 7, 8), (1, 6, 1, 3)])
def test_flow_warp_plain_version_is_grid_sample(padding, n, h, w, c):
    """K4's plain version is ``F.grid_sample`` over BasicSR's grid, bit for
    bit the source's ``flow_warp``, on flows reaching three images out of the
    frame, exact integers and sub-pixel steps; the kernel's own arithmetic
    (the point as ``j + flow``) within ``KERNEL_ATOL_REL * max|x| +
    KERNEL_RTOL |want|`` of it. With a frame slot the output is ``[frame,
    warp(x)]``. On CPU tensors no launch is counted."""
    g = torch.Generator().manual_seed(n * 1000 + h * 10 + w)
    x = torch.randn(n, h, w, c, generator=g) * 3
    flow = (torch.rand(n, h, w, 2, generator=g) - 0.5) * 6 * torch.tensor([w, h])
    flow[0, 0, 0] = torch.tensor([1.0, -2.0])  # integer steps: corners on the grid
    before = (dict(k4.flow_warp.launches_by_mode), dict(k4.flow_warp.launches_by_shape))
    got = k4.flow_warp(x, flow, padding)
    assert before == (dict(k4.flow_warp.launches_by_mode), dict(k4.flow_warp.launches_by_shape))
    want = ref.flow_warp(x.permute(0, 3, 1, 2), flow, padding_mode=padding).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    emulated = kernel_arithmetic(x, flow, padding)
    tol = k4.KERNEL_ATOL_REL * x.abs().max() + k4.KERNEL_RTOL[torch.float32] * want.abs()
    assert ((emulated - want.double()).abs() <= tol).all()
    frame = torch.randn(n, h, w, 8, generator=g).bfloat16()
    fused = k4.flow_warp(x.bfloat16(), flow, padding, frame)
    assert torch.equal(fused, torch.cat([frame, k4.flow_warp(x.bfloat16(), flow, padding)], -1))


def test_flow_warp_reads_a_channel_window():
    """The propagation's input to K4: both branches' states as two 64-channel
    windows of the tensor that stacks them (image stride 64, pixel stride
    128). ``pixel_strides`` reads those strides, and of a contiguous tensor
    (C, or 0 for one image), and refuses a layout whose pixels are not
    evenly spaced; the plain version on the windows equals it on their
    contiguous copies."""
    g = torch.Generator().manual_seed(7)
    stacked = torch.randn(1, 9, 15, 128, generator=g).bfloat16()
    windows = stacked.view(9, 15, 2, 64).permute(2, 0, 1, 3)
    assert k4.pixel_strides(windows) == (64, 128)
    assert k4.pixel_strides(torch.zeros(3, 9, 15, 3)) == (9 * 15 * 3, 3)
    assert k4.pixel_strides(stacked) == (0, 128)
    assert k4.pixel_strides(torch.zeros(2, 15, 9, 3).permute(0, 2, 1, 3)) is None
    flow = (torch.rand(2, 9, 15, 2, generator=g) - 0.5) * 8
    frame = torch.randn(2, 9, 15, 8, generator=g).bfloat16()
    got = k4.flow_warp(windows, flow, "zeros", frame)
    assert got.is_contiguous() and got.shape == (2, 9, 15, 72)
    assert torch.equal(got, k4.flow_warp(windows.contiguous(), flow, "zeros", frame))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_branches_step_is_each_trunk_on_its_own(dtype):
    """One step of ``Branches`` (each block conv of both branches one
    grouped conv over their stacked streams) equals each branch's trunk
    computed alone with ungrouped convs and the same rounding points (the
    conv rounded, then its bias, each leaky ReLU and residual sum), bit for
    bit on the CPU; ``conv_in`` reads the trunk input's 72 channels through
    its kernel laid out on them (the frame's 3, then the 64 warped ones)."""
    from image_super_resolution_tpu_torch.models.basicvsr import FRAME_SLOT, SLOPE, BasicVSR

    conv2d = torch.nn.functional.conv2d
    torch.manual_seed(3)
    m = BasicVSR(width=WIDTH, blocks=BLOCKS, dtype=dtype, device="cpu").eval()
    z = torch.randn(2, 12, 20, FRAME_SLOT + WIDTH).to(dtype)
    z[..., 3:FRAME_SLOT] = 0

    def alone(k, trunk):
        w_in = getattr(m.branches, f"w_in{k}")
        assert torch.equal(w_in[:, :3], trunk.conv_in.conv.weight[:, :3])
        assert torch.equal(w_in[:, FRAME_SLOT:], trunk.conv_in.conv.weight[:, 3:])
        assert not w_in[:, 3:FRAME_SLOT].any()
        h = conv2d(z[k:k + 1].permute(0, 3, 1, 2), w_in, None, padding=1)
        h = torch.nn.functional.leaky_relu_(h.add_(trunk.conv_in.conv.bias.view(1, -1, 1, 1)),
                                            SLOPE)
        for b in range(BLOCKS):
            c0, c1 = (getattr(getattr(trunk, f"block{b}"), f"conv{i}").conv for i in range(2))
            r = torch.relu(conv2d(h, c0.weight, c0.bias, padding=1))
            h = h + conv2d(r, c1.weight, None, padding=1).add_(c1.bias.view(1, -1, 1, 1))
        return h.permute(0, 2, 3, 1)

    with torch.no_grad():
        got = m.branches(z, m.branches.operands())
        want = torch.cat([alone(0, m.backward_trunk), alone(1, m.forward_trunk)], -1)
    assert got.shape == (1, 12, 20, 2 * WIDTH) and torch.equal(got, want)


# ------------------------------------------------------------ the model ----

def test_parameter_count_at_published_widths():
    """Width 64, 30 blocks a branch: 6,291,311 parameters in the port's
    serving graph, in BasicSR's module and in the benchmark's reference (2 x
    2,254,336 in the trunks, 8,256 in the fusion, 334,083 in the upsampler,
    6 x 240,050 in SPyNet)."""
    spec = DeploySpec(family="basicvsr", width=64, blocks=30, scale=4)
    port = sum(math.prod(v.shape) for v in spec.build_model(device="meta").state_dict().values())
    with torch.device("meta"):
        source = sum(p.numel() for p in ref.BasicVSR(num_feat=64, num_block=30).parameters())
    cfg = {**CFG, "width": 64, "blocks": 30}
    bench = sum(math.prod(s) for s in plain.param_shapes(cfg).values())
    assert port == source == bench == 6_291_311
    assert family_defaults("basicvsr") == (30, 64)


@pytest.mark.parametrize("seed", [1, 2])
def test_port_matches_the_references(seed):
    """Seeded weights, 5 frames of 40 x 72. float32: the model's ``y``
    within 1e-5 of the source's (the same convs; the port lays conv_in out
    on 72 channels and runs SPyNet's two directions as one batch, so sums
    run in another order), and the uint8 frames within 1 LSB of the
    benchmark's reference (a rounding at .5 may flip), measured 0. bf16 (the
    served precision) against the float32 reference: measured RMS 0.15-0.19
    LSB, largest 1; bounds 0.5 and 2, the error growing along the forward
    branch's recurrence."""
    weights = make_weights(plain.param_shapes(CFG), seed, "cpu")
    x = frames(seed)
    want = plain.make(weights, CFG, [], "cpu")(x)
    d32 = DeployedModel(SMALL, params_to_jax(weights), torch.float32, "cpu")
    got = d32(x).numpy()
    assert got.shape == want.shape == (5, 160, 288, 3)
    rms, worst = lsb(got, want)
    assert worst <= 1 and rms <= 0.01
    source = ref.BasicVSR(num_feat=WIDTH, num_block=BLOCKS).eval()
    missing, unexpected = source.load_state_dict(source_names(weights), strict=False)
    assert set(missing) == {"spynet.mean", "spynet.std"} and not unexpected
    with torch.no_grad():
        y_source = source(torch.from_numpy(x).permute(0, 3, 1, 2)[None].float() / 255)[0]
        y_port = d32.model(torch.from_numpy(x).float() / 255)
    assert (y_port - y_source.permute(0, 2, 3, 1)).abs().max() <= 1e-5
    rms, worst = lsb(DeployedModel(SMALL, params_to_jax(weights), torch.bfloat16, "cpu")(x)
                     .numpy(), want)
    assert rms <= 0.5 and worst <= 2


def source_names(weights) -> dict:
    """The port's seeded weights under BasicSR's names: the inverse of the
    importer's map."""
    to_source = {}
    for name in weights:
        src = name.replace(".conv.", ".")
        parts = src.split(".")
        if parts[0] == "spynet":
            src = f"spynet.basic_module.{parts[1][5:]}.basic_module.{2 * int(parts[2][4:])}." \
                  f"{parts[3]}"
        elif parts[1] == "conv_in":
            src = f"{parts[0]}.main.0.{parts[2]}"
        elif parts[1].startswith("block"):
            src = f"{parts[0]}.main.2.{parts[1][5:]}.conv{int(parts[2][4:]) + 1}.{parts[3]}"
        else:
            src = src.replace("up0", "upconv1").replace("up1", "upconv2")
        to_source[src] = weights[name]
    return to_source


def test_import_maps_the_source_layout_and_refuses_others():
    """BasicSR's state dict (``spynet.basic_module.{l}.basic_module.{0..8}``,
    ``*_trunk.main.{0, 2.{b}.conv1, 2.{b}.conv2}``, ``fusion``, ``upconv1``,
    ``upconv2``, ``conv_hr``, ``conv_last``, SPyNet's mean and std) imports
    to the port's tree: widths and blocks read from the shapes, the deployed
    float32 model within 1e-5 of the source's forward and 1 LSB of its
    uint8 frames. A missing key, a trunk of other input channels, an
    unknown key or a SPyNet normalisation other than ImageNet's raise
    ``ValueError``."""
    model = source_model(3)
    spec, params = import_basicvsr_state(source_state(model))
    assert (spec.family, spec.width, spec.blocks, spec.scale) == ("basicvsr", WIDTH, BLOCKS, 4)
    assert infer_family_dims(params, "basicvsr") == (BLOCKS, WIDTH)
    x = frames(3)
    deployed = DeployedModel(spec, params, torch.float32, "cpu")
    with torch.no_grad():
        y_source = model(torch.from_numpy(x).permute(0, 3, 1, 2)[None].float() / 255)[0]
        y_port = deployed.model(torch.from_numpy(x).float() / 255)
    y_source = y_source.permute(0, 2, 3, 1)
    assert (y_port - y_source).abs().max() <= 1e-5
    u8 = torch.round(torch.clamp(255 * y_source, 0, 255)).to(torch.uint8).numpy()
    assert lsb(deployed(x).numpy(), u8)[1] <= 1

    sd = source_state(model)
    broken = [{k: v for k, v in sd.items() if k != "fusion.bias"},
              {**sd, "backward_trunk.main.0.weight": sd["backward_trunk.main.0.weight"][:, 1:]},
              {**sd, "extra.weight": sd["fusion.weight"]},
              {**sd, "spynet.mean": sd["spynet.mean"] * 0 + 0.5},
              {k: v for k, v in sd.items() if not k.startswith("backward_trunk")}]
    for bad in broken:
        with pytest.raises(ValueError):
            import_basicvsr_state(bad)


def test_isr_round_trip(tmp_path):
    """An ``.isr`` of the small model reads back its spec (``blocks``, a
    port-only field, written since it differs from the default) and
    params, and serves the fp16-stored weights' outputs."""
    weights = make_weights(plain.param_shapes(CFG), 4, "cpu")
    params = params_to_jax(weights)
    path = tmp_path / "basicvsr.isr"
    save_artifact(path, SMALL, params)
    spec, stored = read_artifact(path)
    assert spec == SMALL
    x = frames(4)
    want = DeployedModel(SMALL, map_tree(lambda a: to_fp32(to_fp16(a)), params), torch.float32,
                         "cpu")(x)
    assert torch.equal(load_artifact(path, torch.float32, "cpu")(x), want)


# ----------------------------------------------------------- the video path --

class _Capture:
    """A stand-in recorder that keeps the frames it is given (BGR)."""

    frames: list = []

    def __init__(self, save_path, video_dimensions=(0, 0), fps=30.0, codec=None):
        _Capture.frames = []

    def write_frame(self, image):
        _Capture.frames.append(np.array(image))

    def stop_recorder(self):
        pass

    def add_audio(self, src):
        return 0


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 37-frame 72 x 40 cv2 mp4v clip, and the small model's ``.isr``."""
    tmp = tmp_path_factory.mktemp("basicvsr")
    path = tmp / "clip.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (72, 40))
    assert writer.isOpened(), "cv2 mp4v encoder unavailable"
    for f in frames(5, t=37):
        writer.write(f)
    writer.release()
    isr = tmp / "basicvsr.isr"
    save_artifact(isr, SMALL, params_to_jax(make_weights(plain.param_shapes(CFG), 5, "cpu")))
    return path, isr


def test_rs_serves_a_clip_in_segments_of_valid_frames(clip, tmp_path, monkeypatch):
    """``rs`` on a 37-frame clip runs BasicVSR through ``video_pipeline`` ->
    ``upscale_batch_device`` -> ``DeployedModel`` in segments of 15 (the
    family's default ``--batch_size``): 15, 15 and 7 frames, each equal bit
    for bit to the model on that segment alone. The last segment as the
    reader pads it (its last frame repeated to 15) gives other frames: the
    padding would reach the valid ones through the backward branch."""
    from image_super_resolution_tpu_torch.video.reader import VideoSource

    path, isr = clip
    monkeypatch.setattr(recorder, "FFMPEGRecorder", _Capture)
    rs.main(["--model", str(isr), "--src", str(path), "--save_dir", str(tmp_path / "up.mp4"),
             "--device", "cpu"])
    got = np.stack(_Capture.frames)[..., ::-1]
    source = VideoSource(path)
    batches = list(source.batches(15))
    source.close()
    assert [n for _, n in batches] == [15, 15, 7]
    deployed = load_artifact(isr, device="cpu")
    want = np.concatenate([deployed(b[:n]).numpy() for b, n in batches])
    assert got.shape == want.shape == (37, 160, 288, 3)
    assert np.array_equal(got, want)
    padded = deployed(batches[-1][0]).numpy()[:7]
    assert not np.array_equal(padded, want[30:])


def test_sequence_model_refuses_tiles_and_shards(clip, tmp_path):
    """The tiler (``upscale_image``), data and spatial sharding and tensor
    parallelism would each cut a segment apart: each refuses a basicvsr
    artifact, naming the family; ``rs`` on an image exits."""
    path, isr = clip
    deployed = load_artifact(isr, device="cpu")
    with pytest.raises(ValueError, match="basicvsr"):
        TiledUpscaler(deployed).upscale_image(frames(6, t=1)[0])
    for kw in (dict(data_devices=2), dict(data_devices=0), dict(spatial_devices=2),
               dict(spatial_grid=(2, 1))):
        with pytest.raises(ValueError, match="basicvsr"):
            TiledUpscaler(deployed, **kw)
    with pytest.raises(SystemExit, match="basicvsr"):
        rs.run(str(isr), str(path), save_dir=str(tmp_path / "o.mp4"), device="cpu",
               tp_devices=2)
    png = tmp_path / "frame.png"
    cv2.imwrite(str(png), frames(6, t=1)[0])
    with pytest.raises(SystemExit, match="sequence model"):
        rs.run(str(isr), str(png), save_dir=str(tmp_path / "o.png"), device="cpu")


def test_spans_and_no_launch_on_the_cpu():
    """A forward opens ``basicvsr/flow``, ``basicvsr/propagate`` and
    ``basicvsr/reconstruct`` once each; a one-frame segment has no flow to
    compute and no warp; the plain versions count no K4 launch."""
    from image_super_resolution_tpu_torch.utils.profiling import annotate

    deployed = DeployedModel(SMALL, params_to_jax(make_weights(plain.param_shapes(CFG), 6,
                                                               "cpu")), torch.float32, "cpu")
    before = {k: tuple(v) for k, v in annotate.totals.items()}
    launches = dict(k4.flow_warp.launches_by_mode)
    assert deployed(frames(6, t=3)).shape == (3, 160, 288, 3)
    for name in ("basicvsr/flow", "basicvsr/propagate", "basicvsr/reconstruct"):
        assert annotate.totals[name][0] - before.get(name, (0, 0))[0] == 1
    assert deployed(frames(6, t=1)).shape == (1, 160, 288, 3)
    assert dict(k4.flow_warp.launches_by_mode) == launches
    with pytest.raises(ValueError, match="32 x 32"):
        deployed(frames(6, t=2, h=32, w=64))
