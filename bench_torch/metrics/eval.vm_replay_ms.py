"""eval.vm_replay_ms: the scorer's "vm" seconds (demo replay and VM runs,
ending in the copy of the verdicts to the host) a window batch, in ms."""


def read(layer):
    vm = layer.get("vm_s")
    return 1e3 * sum(vm) / len(vm) if vm else None
