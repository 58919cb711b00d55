from .loop import TrainState, fit
