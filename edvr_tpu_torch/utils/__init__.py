from edvr_tpu_torch.utils.img_util import img2tensor, imwrite, tensor2img
from edvr_tpu_torch.utils.logger import get_env_info, get_root_logger
from edvr_tpu_torch.utils.misc import (get_time_str, make_exp_dirs,
                                       mkdir_and_rename, scandir)
from edvr_tpu_torch.utils.options import dict2str, parse, parse_dict

__all__ = ['img2tensor', 'imwrite', 'tensor2img', 'get_env_info',
           'get_root_logger', 'get_time_str', 'make_exp_dirs',
           'mkdir_and_rename', 'scandir', 'dict2str', 'parse', 'parse_dict']
