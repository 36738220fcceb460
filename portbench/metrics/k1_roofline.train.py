"""K1's share of its roofline in the train step: the summed bounds of a
step's K1 launches (`portbench/work/`) over their device time in the traced
window, by the kernel's name (`flash_attn_fwd_kernel`), per launch found."""
from portbench.harness import trace as tr


def read(run: dict, cell) -> float:
    t = run.get("trace")
    if not t:
        return None
    secs, found = tr.kernel_time(t, "flash_attn_fwd_kernel")
    work = cell.work().train_work(cell)
    if not found or not work["K1_launches"]:
        return None
    return 100.0 * work["K1"] / work["K1_launches"] * found / secs
