from repro_torch.train.state import TrainState
from repro_torch.train.step import init_state, make_train_step, state_specs
