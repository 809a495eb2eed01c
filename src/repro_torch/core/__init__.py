"""JJPF core: discovery, services, the farm client, skeletons.

    from repro_torch.core import BasicClient
    BasicClient(program, None, tasks, out, lookup=lookup).compute()
"""

from .batching import (AdaptiveBatchController, payload_signature,  # noqa: F401
                       stack_payloads)
from .client import BasicClient  # noqa: F401
from .contracts import ApplicationManager, ParDegreeContract  # noqa: F401
from .discovery import LookupService, ServiceDescriptor, new_service_id  # noqa: F401
from .errors import RemoteProgramError, TransportError  # noqa: F401
from .futures import FarmExecutor  # noqa: F401
from .lease import ControlThread  # noqa: F401
from .leases import Lease, LeaseTable  # noqa: F401
from .normal_form import collect_stage_programs, normal_form_depth, normalize  # noqa: F401
from .pool import ServicePool  # noqa: F401
from .repository import TaskRepository, TaskState  # noqa: F401
from .service import Service, ServiceFailure  # noqa: F401
from .skeletons import Farm, Pipe, Program, Seq, Skeleton, compose_programs, interpret  # noqa: F401
from .transport import (InProcessTransport, LivenessMonitor,  # noqa: F401
                        ProcTransport, ServiceHandle, register_transport,
                        resolve_handle)
