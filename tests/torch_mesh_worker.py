"""What each rank of ``tests/test_torch_mesh.py``'s meshes runs.

The ranks that ``repro_torch.launch.mesh.spawn`` starts import this module
by name, so it imports the port alone (no JAX): each rank joins the mesh,
runs every case on its share of the weights under the mesh, and returns
its outputs and the dispatch probes; the test compares them, in the
parent process, with one process's and with the reference's."""
import torch

from repro_torch.kernels import _build, ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L
from repro_torch.serve.context import ServeContext
from repro_torch.serve.engine import generate
from repro_torch.serve.scheduler import Engine, Request
from repro_torch.sharding import partition as PT


def _probed(fn):
    ops.DISPATCH_COUNTS.clear()
    y = fn()
    return y, dict(ops.DISPATCH_COUNTS)


def run(rank: int, shape: tuple, cases: dict) -> dict:
    """``cases``: {kind: {key: inputs}} (``test_torch_mesh._cases``), on
    ``cases["device"]`` (default the CPU)."""
    device = cases.get("device", "cpu")
    torch.set_num_threads(1)
    mesh = make_mesh(shape, ("data", "model"))
    out = {"coords": dict(mesh.coords)}
    with PT.active_mesh(mesh):
        for key, (w, lut, x, decode) in cases.get("matmul", {}).items():
            pw = PT.place_container(w, mesh)
            out[key] = _probed(lambda: ops.decode_dequant_matmul(
                x, pw, lut, out_dtype=torch.float32, decode=decode)) + (
                pw.mesh_axes, tuple(pw.codes.shape))
        for key, (q, x) in cases.get("k5", {}).items():
            out[key] = _probed(lambda: ops.dequant_matmul(
                x, q.values, q.scale, q.zero, out_dtype=torch.float32))
        for key, (w, lut, xe) in cases.get("k3", {}).items():
            pw = PT.place_container(w, mesh)
            out[key] = _probed(lambda: ops.grouped_decode_dequant_matmul(
                xe, pw, lut, out_dtype=torch.float32)) + (
                pw.mesh_axes, tuple(pw.codes.shape))
        for key, (moe, lut, x, cfg) in cases.get("moe", {}).items():
            placed = PT.place_params(moe, mesh)
            out[key] = _probed(lambda: L.apply_moe(placed, x, cfg, lut=lut))
    for key, (cfg, params, lut, toks, max_new) in cases.get(
            "generate", {}).items():
        placed = PT.place_params(params, mesh)
        ctx = ServeContext(cfg, lut=lut, device=device, mesh=mesh)
        out[key] = _probed(lambda: generate(placed, cfg, toks, ctx=ctx,
                                            max_new=max_new))
    for key, (cfg, params, lut, prompts, max_new) in cases.get(
            "engine", {}).items():
        placed = PT.place_params(params, mesh)
        ctx = ServeContext(cfg, lut=lut, device=device, mesh=mesh)
        eng = Engine(ctx, placed, n_slots=2, max_len=32, page_size=4)
        for i, p in enumerate(prompts):
            eng.submit(Request(tokens=p, max_new=max_new, rid=i))
        eng.drain()
        got = {c.rid: [int(t) for t in c.tokens] for c in eng.completions}
        alone = {i: generate(placed, cfg, torch.as_tensor(p)[None], ctx=ctx,
                             max_new=max_new, max_len=eng.pool.max_len
                             )[0].tolist() for i, p in enumerate(prompts)}
        out[key] = (got, alone)
    out["launches"] = dict(_build.KERNEL_COUNTS)
    return out
