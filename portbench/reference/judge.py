"""The comparison that decides ``correct``.

A run keeps, for the requests drawn for the check, every call of the
program's stage functions with its arguments and its result (the
harness's capture, ``harness/capture.py``). Each stage is judged on what
it was given: the reference (``geometry.py``, float64) computes the
stage's result again from the stage's own inputs and the numbers below
measure how far the program's result lies from it. The voxel keys,
histogram bins, neighbour sets and matches are discontinuous in their
inputs, so a reference chain run from the raw inputs alone could not be
compared row by row; each stage's input is the program's previous result,
which its own stage is judged on. RANSAC's search is not repeated: its
winner is judged by the fitness it reports, recomputed on its
correspondences (the control recomputes it in TF32).

With ``candidate`` set to a :class:`geometry.Precision`, the same inputs
go to the reference at that precision instead of the program, and its
results are judged (the control).

Numbers (the worst over the judged calls):

  deproj_m     largest gap of a deprojected instance point (m);
  deproj_rows  pixels valid on one side only;
  voxel_m      largest gap of a voxel centroid (m);
  voxel_rows   |difference| in the number of voxels;
  normal_rad   90th percentile of the angle between normals (rad);
  fpfh_l1      90th percentile of the L1 gap of a descriptor, on the
               radius route (clouds of 16,384 rows or more, the fused
               and sparse prepares);
  fpfh_knn_l1  its 75th percentile on the k-NN route (smaller clouds),
               where a neighbour at the 100th rank or the radius moves
               more rows;
  corr_rel     99th percentile of the excess of a match's squared
               descriptor distance over the nearest one's, over the
               query descriptor's squared norm;
  ransac_fit   gap of the reported coarse fitness;
  icp_rad      rotation between the refined pose and the reference's ICP
               from the same start (rad);
  icp_m        translation between them (m);
  icp_fit      gap of the refined fitness.

An ICP call is judged where the reference's ICP from its start reaches
the configuration's ``min_fitness``: below it the pose is one the
configuration itself calls unusable (the sparse arm escalates from it),
the normal equations are ill-conditioned, and two roundings of the same
start part ways. Whether the request's final pose is right is
``gate_miss``'s to say.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import geometry as geo
from portbench.reference.frames import deproject_instance

F64 = geo.Precision("float64")

# The quantile compared of each per-row gap: a share of rows larger than
# this may differ by the rounding of float32 (a neighbour at the radius or
# the k-th rank, a bin edge), which a float32 program and a float64
# reference round differently.
QUANTILE = {"normal_rad": 0.9, "fpfh_l1": 0.9, "fpfh_knn_l1": 0.75,
            "corr_rel": 0.99}
# Quantiles recorded besides, for the readings a limit is set from
# (control.py), under "<number>@<quantile>".
DIAG = (0.5, 0.75, 0.9, 0.99, 1.0)


def _quantile(x: torch.Tensor, q: float) -> float:
    if x.numel() == 0:
        return 0.0
    return float(torch.quantile(x.double().cpu(), q))


def _angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.double(), b.double()
    c = (a * b).sum(1) / torch.clamp_min(
        torch.linalg.vector_norm(a, dim=1) * torch.linalg.vector_norm(b, dim=1),
        1e-300)
    return torch.arccos(c.clamp(-1.0, 1.0))


def _valid(cloud):
    return cloud.points[cloud.mask]


class Judge:
    """Accumulates the worst of each number over the judged calls."""

    def __init__(self, min_fitness: float,
                 candidate: geo.Precision | None = None):
        self.min_fitness = min_fitness
        self.candidate = candidate
        self.worst: dict[str, float] = {}
        self.diag: dict[str, float] = {}

    def note(self, name: str, value: float):
        value = float(value)
        if math.isnan(value):
            value = math.inf
        self.worst[name] = max(self.worst.get(name, 0.0), value)

    def rows(self, name: str, x: torch.Tensor):
        """The compared quantile of a per-row gap."""
        self.note(name, _quantile(x, QUANTILE[name]))
        for q in DIAG:
            key = f"{name}@{q}"
            v = _quantile(x, q)
            self.diag[key] = max(self.diag.get(key, 0.0),
                                 math.inf if math.isnan(v) else v)

    # ------------------------------------------------------------ stages

    def deproject(self, rec, frame, inst):
        """``frame``: the request's raw inputs (depth u16, masks, K and the
        depth settings), as the harness made them; ``inst`` the instance."""
        out = rec["out"]
        ref_pts, ref_valid = deproject_instance(frame, inst, F64)
        if self.candidate is not None:
            got_pts, got_valid = deproject_instance(frame, inst,
                                                    self.candidate)
        else:
            got_pts, got_valid = out.points.double(), out.mask
        ref_valid = ref_valid.to(got_valid.device)
        both = ref_valid & got_valid
        self.note("deproj_rows", float((ref_valid ^ got_valid).sum()))
        gap = (got_pts[both].double() - ref_pts.to(got_pts.device)[both])
        self.note("deproj_m", float(gap.abs().max()) if gap.numel() else 0.0)

    def downsample(self, rec):
        cloud, config = rec["args"][0], rec["args"][1]
        voxel = config.voxel_size
        ref = geo.voxel_downsample(cloud.points, cloud.mask, voxel, F64)
        if self.candidate is not None:
            got = geo.voxel_downsample(cloud.points, cloud.mask, voxel,
                                       self.candidate)
        else:
            got = _valid(rec["out"])
        self.note("voxel_rows", abs(got.shape[0] - ref.shape[0]))
        if got.shape[0] == ref.shape[0]:
            self.note("voxel_m", float((got.double() - ref).abs().max()))
        else:
            self.note("voxel_m", math.inf)

    def _features(self, pts, capacity, mode, rows, radius):
        """(reference, candidate or None) normals and FPFH."""
        ref = geo.features(pts, capacity, radius, mode, F64, rows)
        if self.candidate is None:
            return ref, None
        return ref, geo.features(pts, capacity, radius, mode,
                                 self.candidate, rows)

    def prepare(self, rec):
        down, config = rec["args"][0], rec["args"][1]
        mode = rec["args"][2] if len(rec["args"]) > 2 else rec["kwargs"].get(
            "neighbor_mode", "auto")
        voxel = config.voxel_size
        radius = geo.f32(voxel * 5.0)
        pts = _valid(down)
        ref, cand = self._features(pts, down.capacity, mode, None, radius)
        if cand is None:
            cloud, feats = rec["out"]
            got_n = cloud.normals[cloud.mask]
            got_f = feats.descriptors[feats.mask]
        else:
            got_n, got_f = cand
        self.rows("normal_rad", _angle(got_n, ref[0]))
        gap = (got_f.double() - ref[1].double()).abs().sum(1)
        self.rows("fpfh_l1" if geo.radius_route(down.capacity, mode)
                  else "fpfh_knn_l1", gap)

    def prepare_sparse(self, rec):
        cloud = rec["args"][0]
        radius = geo.f32(rec["args"][1])
        sub_cloud, sub_feat, rows = rec["out"]
        keep = sub_feat.mask
        rows = rows[keep].long()
        n_valid = int(cloud.mask.sum())
        if bool((rows >= n_valid).any()) or not torch.equal(
                sub_cloud.points[keep], cloud.points[rows]):
            self.note("fpfh_l1", math.inf)
            return
        pts = _valid(cloud)
        ref, cand = self._features(pts, cloud.capacity, "fused", rows,
                                   radius)
        got_f = (sub_feat.descriptors[keep] if cand is None else cand[1])
        gap = (got_f.double() - ref[1].double()).abs().sum(1)
        self.rows("fpfh_l1", gap)

    def correspondences(self, rec):
        src, tgt = rec["args"][0], rec["args"][1]
        q = src.descriptors[src.mask]
        t = torch.where(tgt.mask[:, None], tgt.descriptors.double(), 1e6)
        if self.candidate is None:
            chosen = rec["out"][src.mask].long()
        else:
            chosen = geo.descriptor_nn(q, t, self.candidate)
        gap = geo.descriptor_gap(q, t, chosen)
        self.rows("corr_rel", gap)

    def ransac(self, rec, children):
        corrs = [c for c in children if c["name"] == "feature_correspondences"]
        if not corrs:
            return
        source, target = rec["args"][0], rec["args"][1]
        voxel = rec["args"][4]
        kw = rec["kwargs"]
        corr_mode = kw.get("corr_mode", "auto")
        corr_cap = kw.get("corr_cap", 8192)
        n = source.capacity
        pts, mask = source.points, source.mask
        if corr_mode in ("subsample", "auto") and n >= 2 * corr_cap:
            sel = geo.strided(n, corr_cap).to(pts.device)
            pts, mask = pts[sel], mask[sel]
        q = target.points[corrs[0]["out"].long()]
        out = rec["out"]
        T = out.transformation
        fit_ref, _ = geo.ransac_fitness(pts, mask, q, T, voxel, F64)
        if self.candidate is not None:
            fit_got, _ = geo.ransac_fitness(pts, mask, q, T, voxel,
                                            self.candidate)
        else:
            fit_got = float(out.fitness)
        if float(out.fitness) == 0.0:
            fit_ref = fit_got = 0.0  # no winner: the identity at fitness 0
        self.note("ransac_fit", abs(fit_got - fit_ref))

    def icp(self, rec):
        source, target, T0, thr = rec["args"][:4]
        kw = rec["kwargs"]
        if not kw.get("point_to_plane", True) or target.normals is None:
            raise NotImplementedError("the reference runs point-to-plane ICP")
        common = dict(src_mode=kw.get("src_mode", "auto"),
                      src_cap=kw.get("src_cap", 16384))
        args = (source.points, source.mask, target.points, target.mask,
                target.normals, T0.cpu().to(source.points.device), thr,
                kw.get("max_iterations", 200))
        T_ref, fit_ref, _ = geo.icp(*args, F64, **common)
        if fit_ref < self.min_fitness:
            return  # no usable pose from this start: see the module's notes
        if self.candidate is None:
            out = rec["out"]
            T_got, fit_got = out.transformation, float(out.fitness)
        else:
            T_got, fit_got, _ = geo.icp(*args, self.candidate, **common)
        rad, m = geo.pose_gap(T_got, T_ref)
        self.note("icp_rad", rad)
        self.note("icp_m", m)
        self.note("icp_fit", abs(fit_got - fit_ref))

    # ------------------------------------------------------------- walk

    def request(self, records, frame=None):
        """Judge one request's captured calls."""
        by_id = {rec["id"]: rec for rec in records}
        by_parent: dict[int, list] = {}
        for rec in records:
            by_parent.setdefault(rec["parent"], []).append(rec)
        for rec in records:
            name = rec["name"]
            if name == "deproject":
                parent = by_id[rec["parent"]]  # _prepare_instance_inner
                self.deproject(rec, frame, parent["args"][4])
            elif name == "downsample_bucketed":
                self.downsample(rec)
            elif name == "prepare_features":
                self.prepare(rec)
            elif name == "fused_prepare_sparse":
                self.prepare_sparse(rec)
            elif name == "feature_correspondences":
                self.correspondences(rec)
            elif name == "ransac_registration":
                self.ransac(rec, by_parent.get(rec["id"], []))
            elif name == "icp_refine":
                self.icp(rec)

