from edvr_tpu_torch.utils.img_util import (imfrombytes, img2tensor, imwrite,
                                           tensor2img)
from edvr_tpu_torch.utils.logger import (MessageLogger, get_env_info,
                                         get_root_logger, init_loggers,
                                         init_tb_logger, init_wandb_logger)
from edvr_tpu_torch.utils.misc import (check_resume, get_time_str,
                                       make_exp_dirs, mkdir_and_rename,
                                       scandir, set_random_seed)
from edvr_tpu_torch.utils.options import dict2str, parse, parse_dict

__all__ = ['imfrombytes', 'img2tensor', 'imwrite', 'tensor2img',
           'MessageLogger', 'get_env_info', 'get_root_logger', 'init_loggers',
           'init_tb_logger', 'init_wandb_logger',
           'check_resume', 'get_time_str', 'make_exp_dirs',
           'mkdir_and_rename', 'scandir', 'set_random_seed', 'dict2str',
           'parse', 'parse_dict']
