"""Dataset registry: name -> (adapter module, class, keyword arguments)
(counterpart of pytracking_tpu/evaluation/datasets.py, with the same
table). Adapters are imported when a dataset is loaded. The synthetic
datasets need nothing on disk; every other one reads its benchmark's tree
from the path its adapter names (evaluation/environment.py), and raises
where that path is not set."""

from __future__ import annotations

import importlib
from collections import namedtuple

from pytracking_tpu_torch.evaluation.data import SequenceList

DatasetInfo = namedtuple("DatasetInfo", ["module", "class_name", "kwargs"])

_BASE = "pytracking_tpu_torch.evaluation.adapters.%s"

dataset_dict = dict(
    synthetic=DatasetInfo(module=_BASE % "synthetic", class_name="SyntheticDataset",
                          kwargs={}),
    synthetic_long=DatasetInfo(module=_BASE % "synthetic", class_name="SyntheticDataset",
                               kwargs={"num_sequences": 5, "num_frames": 120}),
    synthetic_vos=DatasetInfo(module=_BASE % "synthetic",
                              class_name="SyntheticVOSDataset", kwargs={}),
    otb=DatasetInfo(module=_BASE % "otb", class_name="OTBDataset", kwargs={}),
    nfs=DatasetInfo(module=_BASE % "nfs", class_name="NFSDataset", kwargs={}),
    uav=DatasetInfo(module=_BASE % "uav", class_name="UAVDataset", kwargs={}),
    lasot=DatasetInfo(module=_BASE % "lasot", class_name="LaSOTDataset", kwargs={}),
    lasot_train=DatasetInfo(module=_BASE % "lasot",
                            class_name="LaSOTTrainSequencesDataset", kwargs={}),
    lasotvos=DatasetInfo(module=_BASE % "lasot", class_name="LaSOTDataset",
                         kwargs={"vos_mode": True}),
    lasot_extension_subset=DatasetInfo(module=_BASE % "lasotextensionsubset",
                                       class_name="LaSOTExtensionSubsetDataset",
                                       kwargs={}),
    got10k_test=DatasetInfo(module=_BASE % "got10k", class_name="GOT10KDataset",
                            kwargs={"split": "test"}),
    got10k_val=DatasetInfo(module=_BASE % "got10k", class_name="GOT10KDataset",
                           kwargs={"split": "val"}),
    got10k_ltrval=DatasetInfo(module=_BASE % "got10k", class_name="GOT10KDataset",
                              kwargs={"split": "ltrval"}),
    got10kvos_val=DatasetInfo(module=_BASE % "got10k", class_name="GOT10KDataset",
                              kwargs={"split": "val", "vos_mode": True}),
    trackingnet=DatasetInfo(module=_BASE % "trackingnet",
                            class_name="TrackingNetDataset", kwargs={}),
    trackingnetvos=DatasetInfo(module=_BASE % "trackingnet",
                               class_name="TrackingNetDataset",
                               kwargs={"vos_mode": True}),
    vot=DatasetInfo(module=_BASE % "vot", class_name="VOTDataset", kwargs={}),
    vot18=DatasetInfo(module=_BASE % "vot", class_name="VOTDataset", kwargs={}),
    vot22=DatasetInfo(module=_BASE % "vot", class_name="VOTDataset",
                      kwargs={"year": 22}),
    avist=DatasetInfo(module=_BASE % "avist", class_name="AVisTDataset", kwargs={}),
    tpl=DatasetInfo(module=_BASE % "tpl", class_name="TPLDataset", kwargs={}),
    tpl_nootb=DatasetInfo(module=_BASE % "tpl", class_name="TPLDataset",
                          kwargs={"exclude_otb": True}),
    dv2017_val=DatasetInfo(module=_BASE % "davis", class_name="DavisDataset",
                           kwargs={"version": "2017", "split": "val"}),
    dv2016_val=DatasetInfo(module=_BASE % "davis", class_name="DavisDataset",
                           kwargs={"version": "2016", "split": "val"}),
    dv2017_test_dev=DatasetInfo(module=_BASE % "davis", class_name="DavisDataset",
                                kwargs={"version": "2017", "split": "test-dev"}),
    dv2017_test_chal=DatasetInfo(module=_BASE % "davis", class_name="DavisDataset",
                                 kwargs={"version": "2017",
                                         "split": "test-challenge"}),
    yt2019_valid=DatasetInfo(module=_BASE % "youtubevos", class_name="YouTubeVOSDataset",
                             kwargs={"version": "2019", "split": "valid"}),
    yt2019_test=DatasetInfo(module=_BASE % "youtubevos",
                            class_name="YouTubeVOSDataset",
                            kwargs={"version": "2019", "split": "test"}),
    yt2019_valid_all=DatasetInfo(module=_BASE % "youtubevos",
                                 class_name="YouTubeVOSDataset",
                                 kwargs={"version": "2019", "split": "valid",
                                         "all_frames": True}),
    yt2018_valid_all=DatasetInfo(module=_BASE % "youtubevos",
                                 class_name="YouTubeVOSDataset",
                                 kwargs={"version": "2018", "split": "valid",
                                         "all_frames": True}),
    yt2018_jjval=DatasetInfo(module=_BASE % "youtubevos",
                             class_name="YouTubeVOSDataset",
                             kwargs={"version": "2018", "split": "jjvalid"}),
    yt2019_jjval=DatasetInfo(module=_BASE % "youtubevos",
                             class_name="YouTubeVOSDataset",
                             kwargs={"version": "2019", "split": "jjvalid",
                                     "cleanup": ["starts"]}),
    yt2019_jjval_all=DatasetInfo(module=_BASE % "youtubevos",
                                 class_name="YouTubeVOSDataset",
                                 kwargs={"version": "2019", "split": "jjvalid",
                                         "all_frames": True,
                                         "cleanup": ["starts"]}),
    oxuva_dev=DatasetInfo(module=_BASE % "oxuva", class_name="OxUvADataset",
                          kwargs={"split": "dev"}),
    oxuva_test=DatasetInfo(module=_BASE % "oxuva", class_name="OxUvADataset",
                           kwargs={"split": "test"}),
    lagot=DatasetInfo(module=_BASE % "lagot", class_name="LaGOTDataset", kwargs={}),
    lagot_sot=DatasetInfo(module=_BASE % "lagot", class_name="LaGOTDataset",
                          kwargs={"sot_mode": True}),
    lagot_sot_mode=DatasetInfo(module=_BASE % "lagot", class_name="LaGOTDataset",
                               kwargs={"sot_mode": True}),
    mobiface_all=DatasetInfo(module=_BASE % "mobiface", class_name="MobifaceDataset",
                             kwargs={"split": "all"}),
    mobiface_train=DatasetInfo(module=_BASE % "mobiface",
                               class_name="MobifaceDataset",
                               kwargs={"split": "train"}),
    mobiface_test=DatasetInfo(module=_BASE % "mobiface", class_name="MobifaceDataset",
                              kwargs={"split": "test"}),
)


def _dataset_class(name: str):
    name = name.lower()
    if name not in dataset_dict:
        raise ValueError(f"Unknown dataset '{name}'")
    info = dataset_dict[name]
    return getattr(importlib.import_module(info.module), info.class_name), info.kwargs


def load_dataset(name: str, **kwargs) -> SequenceList:
    """One dataset's sequences."""
    cls, base_kwargs = _dataset_class(name)
    return cls(**{**base_kwargs, **kwargs}).get_sequence_list()


def get_dataset(*args, **kwargs) -> SequenceList:
    """The sequences of one or more datasets, by name; keyword arguments
    (e.g. attribute=...) go to every dataset's constructor."""
    dset = SequenceList()
    for name in args:
        dset.extend(load_dataset(name, **kwargs))
    return dset


def get_dataset_attributes(name: str, mode: str = "short", **kwargs):
    """{attribute: SequenceList} of a dataset with attribute annotations,
    else {name: the whole dataset}."""
    cls, base_kwargs = _dataset_class(name)
    ds = cls(**{**base_kwargs, **kwargs})
    if not hasattr(ds, "get_attribute_names") or not ds.get_attribute_names(mode):
        return {name: get_dataset(name)}
    return {att: get_dataset(name, attribute=att) for att in ds.get_attribute_names(mode)}
