# The port's copy of lgteun_tpu/configs/Wavelet.py (the port imports nothing of
# the JAX package); tests/test_torch_port_configs.py keeps them equal.
#
# GSA classical baseline — training-free (reference: configs/GSA.py,
# max_iter = 0, only_test pattern).

import os

name = "Wavelet"
dataset = ["GF-2", "WV-2", "WV-3"]
ms_chans_list = [4, 4, 8]
index = int(os.environ.get("LGTEUN_DATA_INDEX", 2))

datas = dataset[index]
ms_chans = ms_chans_list[index]

model_type = "Wavelet"
data_root = os.environ.get("LGTEUN_DATA_ROOT", "data/PSData3/Dataset")
work_dir = f"data/model_out/{name}"

only_test = True
bit_depth = 11

test_set0_cfg = dict(
    dataset=dict(type="PSDataset",
                 image_dirs=[f"{data_root}/{datas}/test_full_res"],
                 bit_depth=bit_depth),
    batch_size=1, shuffle=False)
test_set1_cfg = dict(
    dataset=dict(type="PSDataset",
                 image_dirs=[f"{data_root}/{datas}/test_reduce_res"],
                 bit_depth=bit_depth),
    batch_size=1, shuffle=False)

seed = 19971118
max_iter = 0
norm_input = True
eval_batch_size = 16
