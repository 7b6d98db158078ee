import torch

# workers share the cores: a few threads each keep them from contending
torch.set_num_threads(2)
