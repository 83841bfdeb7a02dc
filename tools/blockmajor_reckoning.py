"""What K5's block-major order asks of the card, counted with its plain walk:
the cull's tests per lane, and whether staging a block's nodes in shared
memory could pay.

    python tools/blockmajor_reckoning.py [--meshes glasstorus160k,glasstorus640k] [--out FILE]

For each mesh, on the 800x800 frame's 640,000 camera rays and one bounce's
continuation rays (chip_smoke.py ray_cases), it runs
`closest_hit_blockmajor_plain` with the kernel's group cull (`str_groups`,
groups of STREAM_CULL_GROUP blocks) and records every step of its block
walks.  It prints, per live lane: the group tests, the root tests and the
two together, against one root test per block without the cull; and the
8-box node tests of the walk.

Then the staging reckoning, per CTA of the kernel (WALK_THREADS consecutive
lanes): the distinct blocks its lanes enter, and the distinct nodes of each
it touches.  A CTA that copies the node part of every block it enters
(boxes and links, 224 bytes a node, for the rows the block really has)
moves `staged` bytes; the walks fetch today, in 32-byte sectors, 256 bytes a
pop (6 sectors of boxes, 1 of links, 1 of the child-order word): per lane
(`scattered`, every lane's pop its own sectors) or per warp (a node popped
by several lanes of a warp counted once, the least the L1 can make of it).
Staging can pay only if `staged` is well below these.  Needs CUDA (the
plain walk runs on the card); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NODE_STAGED = 48 * 4 + 8 * 4  # a node's boxes and links
POP_SECTORS = 8  # boxes 192 bytes, links 32, child-order word (its own sector)


def block_nodes(subi: np.ndarray, n_sub: int, sub_nodes: int) -> np.ndarray:
    """Rows each block really has: one more than its highest node link."""
    links = subi.reshape(n_sub, sub_nodes, 3, 8)[:, :, 0, :]
    return np.maximum(links.max(axis=(1, 2)), 0) + 1


def reckon(label: str, flat, static, o, d, t0, cta: int) -> dict:
    from pathtracer_tpu_torch.ops import traverse_stream_cuda as ts

    n_sub, S = static.stream_subs, static.stream_sub_nodes
    counts = {"box": 0, "tri": 0, "group": 0, "root": 0, "visits": []}
    tables = (flat.str_roots, flat.str_subf, flat.str_subi, flat.str_subp, flat.str_subt,
              flat.str_base)
    ts.closest_hit_blockmajor_plain(*tables, o, d, t0, sub_nodes=S,
                                    sub_tris=static.stream_sub_tris, counts=counts,
                                    groups=flat.str_groups)
    live = int((t0 >= 0).sum())
    lanes = torch.cat([v[0] for v in counts["visits"]]).long()
    rows = torch.cat([v[1] for v in counts["visits"]]).long()
    pops = lanes.numel()
    nodes = torch.from_numpy(block_nodes(flat.str_subi.cpu().numpy(), n_sub, S)).to(rows.device)
    # (CTA, block) pairs entered and (CTA, node row) pairs touched
    cta_block = torch.unique((lanes // cta) * n_sub + rows // S)
    cta_node = torch.unique((lanes // cta) * (n_sub * S) + rows)
    warp_node = torch.unique((lanes // 32) * (n_sub * S) + rows)
    staged = int(nodes[cta_block % n_sub].sum()) * NODE_STAGED
    ctas = -(-o.shape[0] // cta)
    out = {
        "rays": label, "lanes": o.shape[0], "live": live, "blocks": n_sub,
        "group_tests": counts["group"], "root_tests": counts["root"], "pops": pops,
        "group_tests_per_live_lane": counts["group"] / max(live, 1),
        "root_tests_per_live_lane": counts["root"] / max(live, 1),
        "cull_tests_per_live_lane": (counts["group"] + counts["root"]) / max(live, 1),
        "node_box_tests_per_live_lane": 8 * pops / max(live, 1),
        "ctas": ctas, "cta_block_pairs": int(cta_block.numel()),
        "blocks_entered_per_cta": cta_block.numel() / ctas,
        "nodes_touched_per_entered_block": cta_node.numel() / max(cta_block.numel(), 1),
        "nodes_per_block_mean": float(nodes.float().mean()),
        "staged_bytes": staged, "scattered_bytes_per_lane": pops * POP_SECTORS * 32,
        "scattered_bytes_per_warp": int(warp_node.numel()) * POP_SECTORS * 32,
    }
    out["staged_over_per_warp"] = out["staged_bytes"] / max(out["scattered_bytes_per_warp"], 1)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--meshes", default="glasstorus160k,glasstorus640k")
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("blockmajor_reckoning: needs CUDA", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tools.make_torus_obj import ensure_torus_obj

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    from pathtracer_tpu_torch.scene.flatscene import STREAM_CULL_GROUP

    walk_threads = 128  # csrc/walk_core.cuh WALK_THREADS
    results = []
    for mesh in args.meshes.split(","):
        scene = {"glasstorus160k": (cs.SCENE_160K, cs.TORUS_160K),
                 "glasstorus640k": (cs.SCENE_640K, cs.TORUS_640K)}[mesh]
        ensure_torus_obj(*scene[1])
        r = cs.build_renderer(scene[0])[0]
        closest, _ = cs.ray_cases(r)
        for label in ("camera", "continuation"):
            o, d, t0 = closest[label]
            res = {"mesh": mesh, "group": STREAM_CULL_GROUP,
                   **reckon(label, r.flat, r.static, o, d, t0, walk_threads)}
            results.append(res)
            print(f"{mesh} {label} rays: {res['live']} of {res['lanes']} lanes live, "
                  f"{res['blocks']} blocks in groups of {STREAM_CULL_GROUP}; per live lane "
                  f"{res['group_tests_per_live_lane']:.2f} group + {res['root_tests_per_live_lane']:.2f} "
                  f"root tests = {res['cull_tests_per_live_lane']:.2f} (against {res['blocks']} "
                  f"without the cull), {res['node_box_tests_per_live_lane']:.1f} node box tests; "
                  f"per CTA of {walk_threads} lanes {res['blocks_entered_per_cta']:.2f} blocks "
                  f"entered, {res['nodes_touched_per_entered_block']:.1f} nodes touched of "
                  f"{res['nodes_per_block_mean']:.1f} a block; staged {res['staged_bytes']} bytes "
                  f"against {res['scattered_bytes_per_lane']} (per lane) / "
                  f"{res['scattered_bytes_per_warp']} (per warp) in sectors today: "
                  f"{res['staged_over_per_warp']:.2f}x the per-warp sectors", flush=True)
        del r, closest
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": smi, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
