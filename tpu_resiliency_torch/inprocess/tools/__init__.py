from tpu_resiliency_torch.inprocess.tools.inject_fault import Fault, InjectedFault, inject_fault

__all__ = ["Fault", "InjectedFault", "inject_fault"]
