from tenzing_tpu_torch.solve.mcts.mcts import MctsOpts, MctsResult, SimResult, explore  # noqa: F401
from tenzing_tpu_torch.solve.mcts.node import Node  # noqa: F401
