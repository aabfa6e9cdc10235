# The port's copy of lgteun_tpu/configs/PanFormer.py (the port imports nothing of
# the JAX package); tests/test_torch_port_configs.py keeps them equal.
#
# PanFormer (cross Swin transformer) shipped config — hyperparameters mirror the reference
# (reference: configs/PanFormer.py).

import os

name = "PanFormer"
dataset = ["GF-2", "WV-2", "WV-3"]
ms_chans_list = [4, 4, 8]
index = int(os.environ.get("LGTEUN_DATA_INDEX", 2))

datas = dataset[index]
ms_chans = ms_chans_list[index]

model_type = "PanFormer"
data_root = os.environ.get("LGTEUN_DATA_ROOT", "data/PSData3/Dataset")
work_dir = f"data/model_out/{name}"
log_dir = f"logs/{model_type.lower()}/{datas}"

# Reference configs ship only_test=True with a released checkpoint;
# opt in via env (see configs/unlg_former.py for the rationale).
only_test = os.environ.get("LGTEUN_ONLY_TEST", "0") == "1"
checkpoint = os.environ.get("LGTEUN_CHECKPOINT", "")

# The reference's shipped train loop never calls augmentation
# (reference base_model.py:179-180); opt in with LGTEUN_AUG=1.
aug_dict = {"lr_flip": 0.5, "ud_flip": 0.5} \
    if os.environ.get("LGTEUN_AUG", "0") == "1" else None

bit_depth = 11
train_set_cfg = dict(
    dataset=dict(type="PSDataset",
                 image_dirs=[f"{data_root}/{datas}/train_reduce_res"],
                 bit_depth=bit_depth),
    batch_size=4,
    shuffle=True)
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
max_iter_list = [200000, 200000, 200000]
max_iter = max_iter_list[index]
step_list = [10000, 10000, 10000]
step = step_list[index]

save_freq = 10000
test_freq = 10000
eval_freq = 10000

norm_input = True

optim_cfg = {"core_module": dict(type="Adam", betas=(0.9, 0.999), lr=1e-4)}
sched_cfg = dict(step_size=10000, gamma=0.99)
loss_cfg = {"rec_loss": dict(type="l1", w=1.0)}
model_cfg = {"core_module": dict(n_feats=64, n_heads=8, head_dim=8, win_size=4, n_blocks=3)}

eval_batch_size = 16
