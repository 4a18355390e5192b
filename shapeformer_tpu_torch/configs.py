"""Flagship configuration as Python dicts.

VQDIF_RES16 and SHAPEFORMER_SCALE are the `pl_model_opt.kwargs` of
configs/vqdif/shapenet_res16.yaml and configs/shapeformer/shapenet_scale.yaml
(a CPU test holds them equal), kept here because the machine with the card
has no YAML reader.  DEMO holds the completion settings of
configs/demo/demo_shapeformer.yaml and the demo data's partial-cloud size.
"""
from __future__ import annotations

VQDIF_RES16 = {
    "vq_beta": 0.001,
    "encoder_opt": {
        "class": "shapeformer.models.vqdif.enc.LocalPoolPointnet",
        "kwargs": {
            "c_dim": 32,
            "hidden_dim": 32,
            "plane_type": "grid",
            "grid_resolution": 64,
            "downsampler": True,
            "downsampler_kwargs": {"in_channels": 32, "downsample_steps": 2},
        },
    },
    "quantizer_opt": {
        "class": "shapeformer.models.vqdif.quantizer.Quantizer",
        "kwargs": {"vocab_size": 4096, "n_embd": 128},
    },
    "decoder_opt": {
        "class": "shapeformer.models.vqdif.dec.LocalDecoder",
        "kwargs": {
            "c_dim": 32,
            "hidden_size": 32,
            "sample_mode": "bilinear",
            "unet3d": True,
            "unet3d_kwargs": {"num_levels": 3, "f_maps": 128,
                              "in_channels": 128, "out_channels": 128},
            "upsampler": True,
            "upsampler_kwargs": {"in_channels": 128, "upsampler_steps": 2},
        },
    },
    "optim_opt": {"lr": 0.0001, "scheduler": "StepLR", "step_size": 10,
                  "gamma": 0.9},
}

SHAPEFORMER_SCALE = {
    "tuple_n": 2,
    "voxel_res": 16,
    "block_size": 812,
    "end_tokens": [4096, 4096],
    "vocab_sizes": [4097, 4097],
    "extra_vocab_sizes": [4097],
    "representer_opt": {
        "class": "shapeformer.models.shapeformer.representers.AR_N",
        "kwargs": {
            "voxel_res": 16,
            "block_size": 812,
            "end_tokens": [4096, 4096],
            "uncond": False,
            "no_val_ind": False,
            "random_cind_masking": True,
            "mask_invalid_completion": True,
            "vqvae_opt": {
                "class": "shapeformer.models.vqdif.vqdif.VQDIF",
                "ckpt_path": "experiments/vqdif/shapenet_res16/checkpoints/latest",
                "yaml_path": "configs/vqdif/shapenet_res16.yaml",
            },
        },
    },
    "transformer_opt": {
        "class": "shapeformer.models.shapeformer.transformer.mingpt.CondTupleGPT",
        "kwargs": {
            "tuple_n": 2,
            "vocab_sizes": [4097, 4097],
            "extra_vocab_sizes": [4097],
            "block_size": 812,
            "n_layers": [20, 4],
            "n_head": 16,
            "n_embd": 1024,
            "embd_pdrop": 0.01,
            "resid_pdrop": 0.01,
            "attn_pdrop": 0.01,
        },
    },
    "optim_opt": {"lr": 1.0e-5, "scheduler": "StepLR", "step_size": 10,
                  "gamma": 0.9},
}

DEMO = {
    "sample_n": 4,
    "top_k": 100,
    "top_p": 0.4,
    "temperature": 1.0,
    "sample_max_step": 512,
    "depth": 4,
    "decode_res": 128,
    "context_N": 16384,
}
