"""The port's own copies of the JAX package's jax-free modules: the config
parser has the same flags and defaults (plus ``--device``), the NIfTI module
reads what the JAX package's wrote and the other way round, and the datalist
helpers split a dataset the same way."""

import dataclasses
import json

import numpy as np
import pytest

from medicalsemseg_tpu import config as jcfg
from medicalsemseg_tpu.data import datalist as jdl
from medicalsemseg_tpu.data import nifti as jnifti

from medicalsemseg_tpu_torch import config as pcfg
from medicalsemseg_tpu_torch.data import datalist as pdl
from medicalsemseg_tpu_torch.data import nifti as pnifti


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_has_the_same_flags_and_defaults():
    want, got = _actions(jcfg.build_parser()), _actions(pcfg.build_parser())
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert b.type == a.type and b.nargs == a.nargs, dest
        assert b.choices == a.choices, dest
    assert got["device"].default == "cuda"


def test_config_record_has_the_same_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(jcfg.Config)}
    got = {f.name: f.default for f in dataclasses.fields(pcfg.Config)}
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("argv", [
    [],
    ["--vol_size", "128", "64", "32", "--window_size", "6", "4", "4", "2",
     "--t_voxel_dims", "1.5", "1.5", "2.0", "--remat", "--no_pin_memory"],
    ["--mixed_precision", "--depths", "1", "1", "--no_pallas_train",
     "--gradient_clipping", "1.5", "--no_remat"],
])
def test_get_args_parses_like_the_jax_package(argv):
    want = dataclasses.asdict(jcfg.get_args(argv))
    got = dataclasses.asdict(pcfg.get_args(argv + ["--device", "cpu"]))
    assert got.pop("device") == "cpu"
    assert got == want
    assert pcfg.get_args(argv).window_sizes() == jcfg.get_args(argv).window_sizes()


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int16])
def test_nifti_round_trips_across_the_two_packages(tmp_path, dtype):
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(9, 7, 5)) * 50).astype(dtype)
    aff = np.diag([-1.5, 0.8, 2.0, 1.0])
    aff[:3, 3] = (3.0, -4.0, 5.0)
    jnifti.save(jnifti.NiftiImage(data, aff), str(tmp_path / "j.nii.gz"))
    got = pnifti.load(str(tmp_path / "j.nii.gz"))
    np.testing.assert_array_equal(got.data, data)
    np.testing.assert_allclose(got.affine, aff)
    pnifti.save(pnifti.NiftiImage(data, aff), str(tmp_path / "p.nii"))
    back = jnifti.load(str(tmp_path / "p.nii"))
    np.testing.assert_array_equal(back.data, data)
    np.testing.assert_allclose(back.affine, aff)
    ras_p = pnifti.to_ras(data[..., None], aff)
    ras_j = jnifti.to_ras(data[..., None], aff)
    np.testing.assert_array_equal(ras_p[0], ras_j[0])
    np.testing.assert_allclose(ras_p[1], ras_j[1])


def test_cv_split_matches(tmp_path):
    task = tmp_path / "Task01_X"
    task.mkdir()
    training = [{"image": f"./imagesTr/i{k}.nii.gz",
                 "label": f"./labelsTr/i{k}.nii.gz"} for k in range(11)]
    with open(task / "dataset.json", "w") as f:
        json.dump({"training": training, "test": ["./imagesTs/t0.nii.gz"]}, f)
    for fold in (0, 2):
        kw = dict(data_path=str(tmp_path), task="Task01_X", cv_fold=fold,
                  cv_max_folds=4)
        assert (pdl.build_cv_file_lists(pcfg.Config(**kw))
                == jdl.build_cv_file_lists(jcfg.Config(**kw)))
    assert (pdl.load_decathlon_datalist(str(task / "dataset.json"), "test")
            == jdl.load_decathlon_datalist(str(task / "dataset.json"), "test"))


def test_experiment_tags_match():
    from medicalsemseg_tpu.utils.tags import tag_builder
    from medicalsemseg_tpu_torch.utils.tags import experiment_tags

    for task in ("Task03_Liver", "Abdomen", "Other"):
        assert (experiment_tags(pcfg.Config(task=task, input_dim=3))
                == tag_builder(jcfg.Config(task=task, input_dim=3)))
