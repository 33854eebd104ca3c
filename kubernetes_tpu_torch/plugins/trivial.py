"""NodeName, NodePorts, NodeUnschedulable, ImageLocality — small batched plugins
(plain torch).

Reference: pkg/scheduler/framework/plugins/{nodename,nodeports,nodeunschedulable,
imagelocality}/.
"""

from __future__ import annotations

import torch

from ..framework.events import ActionType, ClusterEvent, EventResource
from ..framework.interface import MAX_NODE_SCORE, Plugin
from ..framework.podbatch import TOL_OP_EXISTS
from ..state.dictionary import ID_UNSCHEDULABLE_TAINT, ID_WILDCARD_IP, MISSING

_MB = 1024 * 1024
MIN_THRESHOLD = 23 * _MB  # imagelocality/image_locality.go:34
MAX_CONTAINER_THRESHOLD = 1000 * _MB  # :35


class NodeNamePlugin(Plugin):
    """pod.Spec.NodeName == node.Name (nodename/node_name.go)."""

    name = "NodeName"

    def filter(self, batch, snap, dyn, aux=None):
        unset = batch.node_name_id == MISSING  # [B]
        return unset[:, None] | (batch.node_name_id[:, None] == snap.node_name_ids[None, :])


class NodePortsPlugin(Plugin):
    """hostPort conflicts vs NodeInfo.UsedPorts (nodeports/node_ports.go).

    Exact HostPortInfo.CheckConflict semantics (framework/types.go): entries
    with equal (proto<<16 | port) codes conflict iff the hostIPs are equal or
    either side is 0.0.0.0 (ID_WILDCARD_IP).
    """

    name = "NodePorts"

    def events_to_register(self):
        return [ClusterEvent(EventResource.POD, ActionType.DELETE)]

    def filter(self, batch, snap, dyn, aux=None):
        pod_ports = batch.ports[:, None, :, None]  # [B, 1, PP, 1]
        node_ports = snap.ports[None, :, None, :]  # [1, N, 1, NP]
        pod_ip = batch.ports_ip[:, None, :, None]
        node_ip = snap.ports_ip[None, :, None, :]
        ip_clash = (
            (pod_ip == node_ip)
            | (pod_ip == ID_WILDCARD_IP)
            | (node_ip == ID_WILDCARD_IP)
        )
        conflict = ((pod_ports == node_ports) & (pod_ports != MISSING)
                    & ip_clash).any(dim=-1).any(dim=-1)
        return ~conflict


class NodeUnschedulablePlugin(Plugin):
    """node.Spec.Unschedulable, escapable by tolerating the
    node.kubernetes.io/unschedulable:NoSchedule taint
    (nodeunschedulable/node_unschedulable.go)."""

    name = "NodeUnschedulable"

    def events_to_register(self):
        return [ClusterEvent(EventResource.NODE, ActionType.ADD | ActionType.UPDATE_NODE_TAINT)]

    def filter(self, batch, snap, dyn, aux=None):
        # tolerates synthetic taint {key: unschedulable, value: "", effect NoSchedule}
        key_ok = (batch.tol_key == MISSING) | (batch.tol_key == ID_UNSCHEDULABLE_TAINT)
        effect_ok = (batch.tol_effect == -1) | (batch.tol_effect == 0)
        value_ok = batch.tol_op == TOL_OP_EXISTS  # Equal would need value ""
        tolerates = (batch.tol_valid & key_ok & effect_ok & value_ok).any(dim=-1)
        return ~snap.unschedulable[None, :] | tolerates[:, None]


def image_scaled_by_id(snap) -> torch.Tensor:
    """f32[num_ids]: each image id's size scaled by its spread (the fraction
    of valid nodes holding it) — per-id scatters over dictionary ids in
    place of the reference's per-node ImageStates walk."""
    img = snap.image_ids  # [N, I]
    dev = img.device
    valid_img = (img != MISSING) & snap.node_valid[:, None]
    num_ids = snap.numeric.shape[0]
    flat = img.clamp(0, num_ids - 1).reshape(-1).long()
    w = valid_img.reshape(-1).float()
    counts_by_id = torch.zeros(num_ids, dtype=torch.float32, device=dev).index_add_(
        0, flat, w)
    size_by_id = torch.zeros(num_ids, dtype=torch.float32, device=dev).scatter_reduce_(
        0, flat, torch.where(valid_img, snap.image_sizes, 0.0).reshape(-1),
        reduce="amax", include_self=True)
    n_nodes = torch.clamp(snap.node_valid.sum(), min=1).float()
    return size_by_id * (counts_by_id / n_nodes)


def image_max_threshold(image_ids) -> torch.Tensor:
    """f32[B]: MAX_CONTAINER_THRESHOLD × max(#containers with an image, 1),
    computed in int32 with two's-complement wrap exactly like the reference."""
    num_containers = (image_ids != MISSING).sum(dim=-1)
    v = torch.clamp(num_containers, min=1).long() * MAX_CONTAINER_THRESHOLD
    v = (v + (1 << 31)) % (1 << 32) - (1 << 31)
    return v.float()


class ImageLocalityPlugin(Plugin):
    """Scaled sum of present-image sizes × spread ratio
    (imagelocality/image_locality.go:84-117)."""

    name = "ImageLocality"

    def score(self, batch, snap, dyn, aux=None, mask=None):
        return image_locality_plane(batch.image_ids, snap, image_scaled_by_id(snap))

    def normalize(self, scores, mask):
        return scores


def image_locality_plane(pod_image_ids, snap, scaled_by_id):
    """f32[B, N] ImageLocality raw score from the per-id scaled sizes.  The
    pod's images are summed in ascending container order."""
    img = snap.image_ids
    valid_img = (img != MISSING) & snap.node_valid[:, None]
    num_ids = scaled_by_id.shape[0]
    pod_img = pod_image_ids.clamp(0, num_ids - 1).long()  # [B, CI]
    pod_scaled = torch.where(pod_image_ids != MISSING, scaled_by_id[pod_img], 0.0)
    present = ((pod_image_ids[:, None, :, None] == img[None, :, None, :])
               & valid_img[None, :, None, :]).any(dim=-1)  # [B, N, CI]
    terms = pod_scaled[:, None, :] * present.float()  # [B, N, CI]
    sum_scores = torch.zeros(terms.shape[:2], dtype=torch.float32,
                             device=terms.device)
    for k in range(terms.shape[-1]):
        sum_scores = sum_scores + terms[..., k]
    max_threshold = image_max_threshold(pod_image_ids)[:, None]
    clamped = torch.minimum(torch.maximum(sum_scores, torch.tensor(
        float(MIN_THRESHOLD), device=terms.device)), max_threshold)
    return (float(MAX_NODE_SCORE) * (clamped - float(MIN_THRESHOLD))
            / (max_threshold - float(MIN_THRESHOLD)))
