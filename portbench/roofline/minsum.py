"""The least time of a min-sum decode: its operations and its bytes.

The operations are the algorithm's, counted per edge lane and per
variable lane of H and per iteration a frame runs (frozen from the port's
kernel accounting): the check's two-minima fold and its outputs (11), the
layered update's extrinsic, delta and posterior add (3) or the flooding
variable rule's add and subtract (2), the syndrome's xor (1), and the
hard decision of each variable (1); one syndrome pass more a frame, the
test of the channel's decisions. A frame counts the iterations its decode
reported, not those its tile ran. The bytes are the LLRs read once
(float32) and the answer written once: the codeword (a byte a bit), the
iteration count (4 bytes) and the success flag (1).
"""

CHECK_OPS, VAR_EDGE_OPS, VAR_LANE_OPS, SYN_OPS, LAYERED_EXTRA_OPS = 11, 2, 1, 1, 3


def operations(schedule: str, edges: int, variables: int, iterations: int,
               frames: int) -> int:
    """Operations of ``frames`` frames that ran ``iterations`` iterations
    in all, on a code of ``edges`` ones in H and ``variables`` columns."""
    update = LAYERED_EXTRA_OPS if schedule == "layered" else VAR_EDGE_OPS
    per_edge = CHECK_OPS + update + SYN_OPS
    per_iteration = edges * per_edge + variables * VAR_LANE_OPS
    return iterations * per_iteration + frames * edges * SYN_OPS


def bytes_moved(variables: int, frames: int) -> int:
    return frames * (variables * (4 + 1) + 4 + 1)


def least_seconds(ops: int, nbytes: int, ops_per_s: float, bytes_per_s: float):
    """(seconds, "operations" or "bytes"): the larger of the two times."""
    by_ops, by_bytes = ops / ops_per_s, nbytes / bytes_per_s
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")
