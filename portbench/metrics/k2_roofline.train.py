"""K2's share of its roofline in the train step: the summed bounds of a
step's K2 launches (`portbench/work/`) over the device time of both its
passes (`flash_attn_bwd_dq_kernel`, `flash_attn_bwd_dkdv_kernel`) in the
traced window, per launch found (a launch is one of each pass)."""
from portbench.harness import trace as tr


def read(run: dict, cell) -> float:
    t = run.get("trace")
    if not t:
        return None
    dq, n_dq = tr.kernel_time(t, "flash_attn_bwd_dq_kernel")
    dkdv, n_dkdv = tr.kernel_time(t, "flash_attn_bwd_dkdv_kernel")
    work = cell.work().train_work(cell)
    found = min(n_dq, n_dkdv)
    if not found or not work["K2_launches"]:
        return None
    return 100.0 * work["K2"] / work["K2_launches"] * found / (dq + dkdv)
