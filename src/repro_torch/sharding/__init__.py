"""The distributed round and mesh serving on ``torch.distributed``
(counterpart of ``repro/sharding``)."""
from repro_torch.sharding import rules  # noqa: F401
from repro_torch.sharding.fl_step import (make_fl_train_step,  # noqa: F401
                                          make_fl_train_step_tau)
from repro_torch.sharding.serve import (make_prefill_step,  # noqa: F401
                                        make_serve_step)
